"""The CUDA kernels of foveax_torch on the card: each wrapper against its
plain version (tolerance 0, the SAT compared through its int32 view), its
input checks and its launch count; the SAT and direct pipelines against the
fused one; the streaming server and client on the card; the sharded
functions and the mesh server of chip_smoke.py's phase 9; K5,
``segreduce_xy`` and ``unwarp_xy`` at 16K and the serving soak's CUDA
memory (phases 11 and 13); K7, the SAT path's 4-tap sampler, on the
path's taps at 1080p and 4K, random seam taps, wrapped SAT words and odd
widths, with its checks and its count; the SAT serve tick at 8K on
frames whose channel totals wrap past 2^32, against the benchmark's plain
reference; the fused serve tick at 1080p with a channel's 32 gazes,
against the same tick on the CPU.

These tests need a CUDA device and skip without one.  On the card, run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which the port's
machine does not need)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from benchmark.inputs import gaze_trace
from benchmark.reference.foveation import BoxFilter
from foveax_torch import FoveaxConfig, FoveationPipeline
from foveax_torch.config import reduced_dim
from foveax_torch.core.logrect import make_grid, scaled_center
from foveax_torch.core import sample as core_sample
from foveax_torch.core.sample import _axis_taps
from foveax_torch.io.wirecodec import available_wire_codecs
from foveax_torch.kernels import fused_select as fs
from foveax_torch.kernels import sat_sample as ss
from foveax_torch.kernels import scan2d
from foveax_torch.kernels import segreduce as sr
from foveax_torch.kernels import unwarp as uw
from foveax_torch.scripts import soak
from foveax_torch.serve.tick import ServeTick

pytestmark = pytest.mark.cuda

CFG = FoveaxConfig(
    source_width=1920, source_height=512, reduced_width=1072, reduced_height=288
)
CENTERS = [(0.5, 0.5), (0.0, 0.0), (1.0, 1.0), (0.999, 0.001), (0.03, 0.4)]


@pytest.fixture(scope="module")
def pipe():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return FoveationPipeline(CFG)


@pytest.fixture(scope="module")
def frame(pipe):
    rng = np.random.default_rng(13)
    return torch.from_numpy(rng.integers(0, 256, (3, 512, 1920), np.uint8)).cuda()


def _equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.uint32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got.to(torch.int32), want.to(torch.int32))


@pytest.mark.parametrize("batch", [False, True])
def test_sampler_kernels_match_plain(pipe, frame, batch):
    gazes = CENTERS if batch else CENTERS[:1]
    centers = torch.tensor(gazes, dtype=torch.float32, device="cuda")
    pxc, pxmc, vx, pyc, pymc, vy = sr.fused_taps(pipe.grid, frame, centers)
    rows = sr.y_segment_reduce_batch(frame, pymc, pyc)
    _equal(rows, sr.y_segment_reduce_batch_plain(frame, pymc, pyc))
    args = (rows, pxmc, pxc, vx, pymc, pyc, vy)
    _equal(sr.x_segment_reduce_batch(*args), sr.x_segment_reduce_batch_plain(*args))


def _xy_args(grid, frame, gazes):
    centers = torch.tensor(gazes, dtype=torch.float32, device="cuda")
    pxc, pxmc, vx, pyc, pymc, vy = sr.fused_taps(grid, frame, centers)
    return frame, pxmc, pxc, vx, pymc, pyc, vy


@pytest.mark.parametrize("gazes", [[c] for c in CENTERS] + [CENTERS],
                         ids=[str(c) for c in CENTERS] + ["batch"])
def test_xy_kernel_matches_plain(pipe, frame, gazes):
    args = _xy_args(pipe.grid, frame, gazes)
    _equal(sr.segment_reduce_xy_batch(*args), sr.segment_reduce_xy_batch_plain(*args))


def _random_taps(rng, n: int, m: int, dim: int, maxlen: int):
    """In-contract taps in no order: (pc, pmc, valid), each (n, m), with
    intervals of 1..maxlen, the first touching 0 and the last dim - 1."""
    pc = rng.integers(1, dim, (n, m))
    pmc = np.maximum(pc - rng.integers(1, maxlen + 1, (n, m)), 0)
    pc[:, 0], pmc[:, 0] = 1, 0
    pc[:, -1], pmc[:, -1] = dim - 1, max(dim - 1 - maxlen, 0)
    valid = rng.random((n, m)) > 0.2
    return (torch.from_numpy(pc.astype(np.int32)).cuda(),
            torch.from_numpy(pmc.astype(np.int32)).cuda(),
            torch.from_numpy(valid).cuda())


@pytest.mark.parametrize("n, wr, hr", [(1, 1001, 77), (3, 1072, 288)])
@pytest.mark.parametrize("base", ["aligned", "offset"])
def test_xy_kernel_any_taps(pipe, frame, n, wr, hr, base):
    """Random in-contract taps (row intervals up to 257 rows, inside the
    plain version's uint16 bound; column intervals up to the whole row),
    an output width that is not a multiple of 16, and a frame whose base is
    one byte past an aligned address (no row start is 16-byte aligned)."""
    rng = np.random.default_rng(n + wr)
    if base == "offset":
        buf = torch.empty(frame.numel() + 1, dtype=torch.uint8, device="cuda")
        frame = buf[1:].view(frame.shape).copy_(frame)
    _, h, w = frame.shape
    pxc, pxmc, vx = _random_taps(rng, n, wr, w, w - 1)
    pyc, pymc, vy = _random_taps(rng, n, hr, h, 257)
    args = (frame, pxmc, pxc, vx, pymc, pyc, vy)
    _equal(sr.segment_reduce_xy_batch(*args), sr.segment_reduce_xy_batch_plain(*args))


def test_xy_kernel_odd_width():
    """1000x500 -> 560x288: a source width that is not a multiple of 16,
    so row starts alternate between 16- and 8-byte alignment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    odd = FoveationPipeline(FoveaxConfig(
        source_width=1000, source_height=500, reduced_width=560,
        reduced_height=288,
    ))
    assert odd.sampler == "fused"
    rng = np.random.default_rng(11)
    frame = torch.from_numpy(rng.integers(0, 256, (3, 500, 1000), np.uint8)).cuda()
    args = _xy_args(odd.grid, frame, CENTERS)
    _equal(sr.segment_reduce_xy_batch(*args), sr.segment_reduce_xy_batch_plain(*args))


@pytest.mark.parametrize("center", CENTERS)
def test_unwarp_kernels_match_plain(pipe, frame, center):
    c = pipe.center(*center)
    reduced = pipe.foveate_chw(frame, c)
    xv, yv = uw.fused_vectors(288, 1072, 1920, 512, c)
    _equal(uw.unwarp_xy(reduced, xv, yv), uw.unwarp_xy_plain(reduced, xv, yv))


def _random_vectors(rng, n: int, size: int):
    """In-contract vectors of no particular order: lo/hi anywhere in
    [0, size), den in [1, 255], num in [0, den]."""
    den = rng.integers(1, 256, n)
    vecs = (rng.integers(0, size, n), rng.integers(0, size, n),
            rng.integers(0, den + 1), den)
    return tuple(torch.from_numpy(v.astype(np.int32)).cuda() for v in vecs)


@pytest.mark.parametrize("case", ["random", "odd-width"])
def test_unwarp_xy_any_vectors(pipe, frame, case):
    """Random vectors make a band's rows span far more than BAND_ROWS + 1,
    so the kernel stages them in pieces; at width 1000 (not a multiple of
    16) every store is narrow, here with the inverse map's y vectors."""
    rng = np.random.default_rng(5)
    reduced = pipe.foveate_chw(frame, pipe.center(0.5, 0.5))
    if case == "random":
        xv, yv = _random_vectors(rng, 1920, 1072), _random_vectors(rng, 512, 288)
    else:
        _, yv = uw.fused_vectors(288, 1072, 1920, 512, pipe.center(0.3, 0.6))
        xv = _random_vectors(rng, 1000, 1072)
    _equal(uw.unwarp_xy(reduced, xv, yv), uw.unwarp_xy_plain(reduced, xv, yv))


def test_pipeline_matches_cpu(pipe, frame):
    cpu = FoveationPipeline(CFG, device="cpu")
    c = (0.37, 0.62)
    red = pipe.foveate_chw(frame, pipe.center(*c))
    want = cpu.foveate_chw(frame.cpu(), cpu.center(*c))
    assert torch.equal(red.cpu(), want)
    assert torch.equal(
        pipe.unwarp_auto_chw(red, pipe.center(*c)).cpu(),
        cpu.unwarp_auto_chw(want, cpu.center(*c)),
    )
    assert pipe.device.type == "cuda"


def test_each_launch_counts_once(pipe, frame):
    kernels = (sr.XY_PASS, sr.Y_PASS, sr.X_PASS, uw.UNWARP_XY)
    before = [k.launches for k in kernels]
    c = pipe.center(0.5, 0.5)
    pipe.unwarp_auto_chw(pipe.foveate_chw(frame, c), c)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 0, 0, 1]


def test_wrappers_check_inputs(pipe, frame):
    centers = pipe.center(0.5, 0.5)[None]
    pxc, pxmc, vx, pyc, pymc, vy = sr.fused_taps(pipe.grid, frame, centers)
    with pytest.raises(ValueError, match="frame"):
        sr.y_segment_reduce_batch(frame.to(torch.int32), pymc, pyc)
    with pytest.raises(ValueError, match="contiguous"):
        sr.y_segment_reduce_batch(frame, pymc, pyc.repeat_interleave(2, 1)[:, ::2])
    with pytest.raises(ValueError, match="pc"):
        sr.y_segment_reduce_batch(frame, pymc, pyc.cpu())
    rows = sr.y_segment_reduce_batch(frame, pymc, pyc)
    with pytest.raises(ValueError, match="valid_x"):
        sr.x_segment_reduce_batch(rows, pxmc, pxc, vx.int(), pymc, pyc, vy)
    xy = sr.segment_reduce_xy_batch
    with pytest.raises(ValueError, match="frame"):
        xy(frame.to(torch.int32), pxmc, pxc, vx, pymc, pyc, vy)
    with pytest.raises(ValueError, match="frame: must be contiguous"):
        xy(frame.transpose(1, 2).contiguous().transpose(1, 2), pxmc, pxc, vx,
           pymc, pyc, vy)
    with pytest.raises(ValueError, match="pxmc"):
        xy(frame, pxmc[:, :-1], pxc, vx, pymc, pyc, vy)
    with pytest.raises(ValueError, match="valid_x"):
        xy(frame, pxmc, pxc, vx.int(), pymc, pyc, vy)
    with pytest.raises(ValueError, match="pymc"):
        xy(frame, pxmc, pxc, vx, pymc.long(), pyc, vy)
    with pytest.raises(ValueError, match="pyc"):
        xy(frame, pxmc, pxc, vx, pymc, pyc.cpu(), vy)
    with pytest.raises(ValueError, match="valid_y"):
        xy(frame, pxmc, pxc, vx, pymc, pyc, vy[:, :-1])
    wide = torch.zeros((3, 2, 60000), dtype=torch.uint8, device="cuda")
    one = torch.ones((1, 8), dtype=torch.int32, device="cuda")
    zero, ok = torch.zeros_like(one), torch.ones_like(one, dtype=torch.bool)
    with pytest.raises(ValueError, match="source width 60000"):
        xy(wide, zero, one, ok, zero, one, ok)
    xv, yv = uw.fused_vectors(288, 1072, 1920, 512, centers[0])
    red = torch.zeros((3, 288, 1072), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="planar"):
        uw.unwarp_xy(red[:, :, ::2], xv, yv)
    with pytest.raises(ValueError, match="planar"):
        uw.unwarp_xy(red[:2], xv, yv)
    with pytest.raises(ValueError, match="x_den"):
        uw.unwarp_xy(red, (*xv[:3], xv[3].long()), yv)
    with pytest.raises(ValueError, match="y_hi"):
        uw.unwarp_xy(red, xv, (yv[0], yv[1][:-1], *yv[2:]))
    with pytest.raises(ValueError, match="y_lo"):
        uw.unwarp_xy(red, xv, (yv[0].cpu(), *yv[1:]))


@pytest.mark.parametrize(
    "shape, fill",
    [((512, 1920), None), ((37, 1000), None), ((2160, 3840), 255)],
    ids=["1920x512", "1000x37", "4k-all-255"],
)
@pytest.mark.parametrize("layout", ["hwc", "chw"])
def test_sat_build_matches_plain(pipe, shape, fill, layout):
    h, w = shape
    if fill is None:
        rng = np.random.default_rng(h + w)
        chw = torch.from_numpy(rng.integers(0, 256, (3, h, w), np.uint8)).cuda()
    else:
        chw = torch.full((3, h, w), fill, dtype=torch.uint8, device="cuda")
    frame = chw if layout == "chw" else chw.permute(1, 2, 0).contiguous()
    got = scan2d.sat_scan(frame, in_layout=layout)
    _equal(got, scan2d.sat_scan_plain(chw))
    if fill is not None:
        corner = int(scan2d.as_int64(got[:, -1, -1])[0])
        assert corner == (255 * h * w) % 2**32


@pytest.mark.parametrize("gaze", CENTERS[:3])
def test_select_rows_matches_plain(pipe, frame, gaze):
    centers = torch.tensor([gaze], dtype=torch.float32, device="cuda")
    *_, pyc, pymc, _ = sr.fused_taps(pipe.grid, frame, centers)
    rcw = frame.permute(1, 0, 2).contiguous()
    got = fs.sat_select_rows(rcw, pyc[0], pymc[0])
    want = fs.sat_select_rows_plain(rcw, pyc[0], pymc[0])
    for g, w_ in zip(got, want):
        _equal(g, w_)
    dup = torch.tensor([0, 0, 5, 5, 5, 511, 511], dtype=torch.int32, device="cuda")
    for g, w_ in zip(fs.sat_select_rows(rcw, dup, dup),
                     fs.sat_select_rows_plain(rcw, dup, dup)):
        _equal(g, w_)


def test_sat_pipeline_matches_fused(pipe, frame):
    sat_pipe = FoveationPipeline(CFG, sampler="sat")
    assert pipe.sampler == "fused" and sat_pipe.sampler == "sat"
    for gaze in CENTERS:
        c = pipe.center(*gaze)
        assert torch.equal(sat_pipe.foveate_chw(frame, c), pipe.foveate_chw(frame, c))
    centers = torch.tensor(CENTERS, dtype=torch.float32, device="cuda")
    hwc = frame.permute(1, 2, 0).contiguous()
    prepare, sample_batch = sat_pipe.batch_pair("sat")
    assert torch.equal(
        sample_batch(prepare(hwc), centers), pipe.sample_batch_fused(hwc, centers)
    )


def test_degrade_to_sat_on_the_card():
    small = FoveaxConfig(
        source_width=1920, source_height=1080, reduced_width=64,
        reduced_height=36,
    )
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    pipe = FoveationPipeline(small)
    assert pipe.sampler == "sat"
    with pytest.raises(ValueError, match="contract"):
        FoveationPipeline(small, sampler="fused")
    rng = np.random.default_rng(4)
    frame = torch.from_numpy(rng.integers(0, 256, (1080, 1920, 3), np.uint8))
    before = (scan2d.SAT_BUILD.launches, ss.SAT_SAMPLE.launches)
    got = pipe.foveate(frame.cuda(), pipe.center(0.3, 0.6))
    torch.cuda.synchronize()
    assert (scan2d.SAT_BUILD.launches, ss.SAT_SAMPLE.launches) == (
        before[0] + 1, before[1] + 1)
    cpu = FoveationPipeline(small, device="cpu")
    assert torch.equal(got.cpu(), cpu.foveate(frame, cpu.center(0.3, 0.6)))
    # Its delta steps exceed 255: "auto" unwarps exactly, with no kernel.
    chw = frame.permute(2, 0, 1).contiguous()
    before = (scan2d.SAT_BUILD.launches, ss.SAT_SAMPLE.launches,
              uw.UNWARP_XY.launches)
    c = pipe.center(0.3, 0.6)
    out = pipe.unwarp_auto_chw(pipe.foveate_chw(chw.cuda(), c), c)
    torch.cuda.synchronize()
    assert (scan2d.SAT_BUILD.launches, ss.SAT_SAMPLE.launches,
            uw.UNWARP_XY.launches) == (before[0] + 1, before[1] + 1, before[2])
    c = cpu.center(0.3, 0.6)
    assert torch.equal(out.cpu(), cpu.unwarp_auto_chw(cpu.foveate_chw(chw, c), c))


def test_sat_launches_count_once(pipe, frame):
    c = pipe.center(0.5, 0.5)
    sat_pipe = FoveationPipeline(CFG, sampler="sat")
    before = (scan2d.SAT_BUILD.launches, fs.SELECT_ROWS.launches,
              ss.SAT_SAMPLE.launches, sr.XY_PASS.launches)
    sat_pipe.foveate_chw(frame, c)
    idx = torch.arange(0, 512, 7, dtype=torch.int32, device="cuda")
    fs.sat_select_rows(frame.permute(1, 0, 2).contiguous(), idx, idx)
    torch.cuda.synchronize()
    assert scan2d.SAT_BUILD.launches - before[0] == 1
    assert fs.SELECT_ROWS.launches - before[1] == 1
    assert ss.SAT_SAMPLE.launches - before[2] == 1
    assert sr.XY_PASS.launches == before[3]


def test_sat_wrappers_check_inputs(pipe, frame):
    with pytest.raises(ValueError, match="frame"):
        scan2d.sat_scan(frame.to(torch.int32), in_layout="chw")
    with pytest.raises(ValueError, match="3 channels"):
        scan2d.sat_scan(frame[:2], in_layout="chw")
    with pytest.raises(ValueError, match="contiguous"):
        scan2d.sat_scan(frame.permute(1, 2, 0), in_layout="hwc")
    rcw = frame.permute(1, 0, 2).contiguous()
    idx = torch.arange(4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="frame_rcw"):
        fs.sat_select_rows(frame, idx, idx)
    with pytest.raises(ValueError, match="pyc"):
        fs.sat_select_rows(rcw, idx.long(), idx)
    with pytest.raises(ValueError, match="pymc"):
        fs.sat_select_rows(rcw, idx, idx.cpu())


def _sat_frame(h: int, w: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (3, h, w), np.uint8)).cuda()


def _k7_equal(sat, taps) -> None:
    """K7 against its plain version in both layouts."""
    for layout in ss.LAYOUTS:
        _equal(ss.sat_sample_batch(sat, *taps, layout),
               ss.sat_sample_batch_plain(sat, *taps, layout))


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("shape", ["1080p", "4k"])
def test_sat_sample_matches_plain(pipe, shape, n):
    """K7 on K5's SAT of a random frame with the path's taps for 1 and 8
    gazes (the batch has the seam gazes), both layouts."""
    p = chip_smoke.make_pipeline(shape, "cuda")
    sat = scan2d.sat_scan(chip_smoke.make_frame(p, 18), in_layout="chw")
    centers = torch.tensor(chip_smoke.BATCH_GAZES[-n:], dtype=torch.float32,
                           device="cuda")
    _k7_equal(sat, chip_smoke.sat_taps(p.grid, sat, centers))


@pytest.mark.parametrize("case", ["random taps", "random taps, offset words"])
def test_sat_sample_random_taps(pipe, case):
    """K7 on random in-contract taps at 4K, three gazes: non-monotone
    columns as at the seam, every third interval ``pmc = pc - 1``; then
    over the SAT's words plus random per-row and per-column offsets mod
    2^32, which cancel in every box but not in the 4-tap difference's
    words."""
    p = chip_smoke.make_pipeline("4k", "cuda")
    sat = scan2d.sat_scan(chip_smoke.make_frame(p, 19), in_layout="chw")
    rng = np.random.default_rng(19)
    args = chip_smoke.sat_sample_extra_cases(rng, sat, 3, 2144, 1200)[case]
    pxc = args[2]
    assert bool((pxc[:, 1:] < pxc[:, :-1]).any())
    assert bool((pxc[:, 1::3] - args[1][:, 1::3] == 1).all())
    _k7_equal(args[0], args[1:])


def test_sat_sample_all_255_wraps(pipe):
    """All-255 8K: the SAT's words wrap past 2^32; every valid cell of K7's
    output is 255."""
    h, w = 4320, 7680
    sat = scan2d.sat_scan(torch.full((3, h, w), 255, dtype=torch.uint8,
                                     device="cuda"), in_layout="chw")
    assert int(scan2d.as_int64(sat[:, -1, -1])[0]) == 255 * h * w % 2**32
    p = FoveationPipeline(FoveaxConfig().with_source(w, h))
    centers = torch.tensor([(0.0, 0.0), (1.0, 1.0), (0.999, 0.001)],
                           dtype=torch.float32, device="cuda")
    taps = chip_smoke.sat_taps(p.grid, sat, centers)
    _k7_equal(sat, taps)
    out = ss.sat_sample_batch(sat, *taps, "chw")
    assert set(torch.unique(out).tolist()) == {0, 255}
    del sat, out
    torch.cuda.empty_cache()


@pytest.mark.parametrize("wr", [560, 1001])
def test_sat_sample_odd_width(pipe, wr):
    """K7 at 1000x500 -> 560x288 with the path's taps, and random taps at
    output width 1001."""
    w, h, _, hr = chip_smoke.ODD_SHAPE
    sat = scan2d.sat_scan(_sat_frame(h, w, 20), in_layout="chw")
    if wr == 560:
        centers = torch.tensor(CENTERS, dtype=torch.float32, device="cuda")
        taps = chip_smoke.sat_taps(make_grid(wr, hr, w, h, "cuda"), sat, centers)
    else:
        rng = np.random.default_rng(20)
        taps = chip_smoke.sat_sample_extra_cases(rng, sat, 2, wr, hr)["random taps"][1:]
    _k7_equal(sat, taps)


def test_sat_sample_checks_and_counts(pipe, frame):
    """K7's wrapper raises on what it does not take, and
    ``sample_rect_from_sat`` on a card SAT launches it once a call, for
    one gaze or eight, and nothing else."""
    sat = scan2d.sat_scan(frame, in_layout="chw")
    centers = torch.tensor(CENTERS, dtype=torch.float32, device="cuda")
    taps = chip_smoke.sat_taps(pipe.grid, sat, centers)
    with pytest.raises(ValueError, match="pxc: on cpu"):
        ss.sat_sample_batch(sat, taps[0], taps[1].cpu(), *taps[2:])
    with pytest.raises(ValueError, match="sat: must be contiguous"):
        ss.sat_sample_batch(sat.transpose(1, 2).contiguous().transpose(1, 2),
                            *taps)
    with pytest.raises(ValueError, match="valid_y: expected torch.bool"):
        ss.sat_sample_batch(sat, *taps[:5], taps[5].int())
    kernels = chip_smoke.kernel_table()
    for cs in (centers[0], centers):
        chip_smoke.zero_counts(kernels)
        out = core_sample.sample_rect_from_sat(sat, pipe.grid, cs, out_layout="chw")
        chip_smoke.expect_counts("sample_rect_from_sat", chip_smoke.read_counts(kernels),
                                 {"sat_sample": 1})
        assert out.shape == (*cs.shape[:-1], 3, 288, 1072)


@pytest.mark.parametrize(
    "h, w",
    [(scan2d.BAND_ROWS * 3 + 5, 256), (1, 1), (1, 17), (70, 1001), (2, 40000 // 3)],
    ids=["h-not-band-multiple", "1x1", "1x17", "width-1001", "k2-width"],
)
@pytest.mark.parametrize("layout", ["hwc", "chw"])
def test_sat_build_edge_shapes(pipe, h, w, layout):
    """Heights that are not a multiple of the band, a single row, widths
    that are not a multiple of 16, and a width that takes two chunks a
    thread (13,333 columns)."""
    chw = _sat_frame(h, w, h * w)
    frame = chw if layout == "chw" else chw.permute(1, 2, 0).contiguous()
    _equal(scan2d.sat_scan(frame, in_layout=layout), scan2d.sat_scan_plain(chw))


@pytest.mark.parametrize("layout", ["hwc", "chw"])
def test_sat_build_unaligned_base(pipe, layout):
    """A frame whose base is one byte past an aligned address: no row or
    pixel window starts on a 16-byte boundary."""
    chw = _sat_frame(75, 640, 9)
    src = chw if layout == "chw" else chw.permute(1, 2, 0).contiguous()
    buf = torch.empty(src.numel() + 1, dtype=torch.uint8, device="cuda")
    frame = buf[1:].view(src.shape).copy_(src)
    assert frame.data_ptr() % 16 == 1
    _equal(scan2d.sat_scan(frame, in_layout=layout), scan2d.sat_scan_plain(chw))


def test_sat_build_8k_wraps(pipe):
    """All-255 8K: the sums wrap past 2^32 (corner 8,460,288,000 mod
    2^32)."""
    h, w = 4320, 7680
    chw = torch.full((3, h, w), 255, dtype=torch.uint8, device="cuda")
    got = scan2d.sat_scan(chw.permute(1, 2, 0).contiguous(), in_layout="hwc")
    _equal(got, scan2d.sat_scan_plain(chw))
    assert int(scan2d.as_int64(got[:, -1, -1])[0]) == 255 * h * w % 2**32


@pytest.mark.parametrize("h, w", [(8640, 15360), (1200, 9001)],
                         ids=["16k", "width-9001"])
@pytest.mark.parametrize("layout", ["hwc", "chw"])
def test_sat_build_two_chunk_plan(pipe, h, w, layout):
    """K5 in its two-chunk launch plan (``chunks_per_thread`` 2) over many
    bands: at 16K, whose 1.59 GB SAT puts byte offsets past 2^31, and at
    width 9001, not a multiple of 16."""
    plan = scan2d.sat_plan(h, w, column_stride=1 if layout == "chw" else 3)
    assert plan.chunks_per_thread == 2 and plan.launches == 3
    chw = _sat_frame(h, w, w)
    frame = chw if layout == "chw" else chw.permute(1, 2, 0).contiguous()
    _equal(scan2d.sat_scan(frame, in_layout=layout), scan2d.sat_scan_plain(chw))
    del chw, frame
    torch.cuda.empty_cache()


# Three column tiles, the last ragged (4,464 columns).
TILED = (256, 70000)


def _row_taps(h: int, w: int, gaze):
    """The sampler's row taps ``(pyc, pymc)`` for one gaze on an H x W
    frame, each (Hr,) int32 on the card (as ``fused_taps`` computes them;
    the fused sampler itself refuses W past 35,888)."""
    grid = make_grid(reduced_dim(w), reduced_dim(h), w, h, "cuda")
    c = torch.tensor([gaze], dtype=torch.float32, device="cuda")
    _, cy = scaled_center(c, w, h)
    pyc, pymc, _ = _axis_taps(grid.gy, cy[:, None], h, wrap=False)
    return pyc[0], pymc[0]


@pytest.mark.parametrize("fill", ["random", "all-255"])
@pytest.mark.parametrize("layout", ["hwc", "chw"])
def test_sat_build_tiled(pipe, layout, fill):
    """K5 over three column tiles at 70000x256: a random frame, and the
    all-255 frame, whose sums wrap past 2^32 across the tiles."""
    h, w = TILED
    plan = scan2d.sat_plan(h, w, column_stride=1 if layout == "chw" else 3)
    assert (plan.tiles, plan.chunks_per_thread) == (3, 4)
    chw = (_sat_frame(h, w, 40) if fill == "random" else
           torch.full((3, h, w), 255, dtype=torch.uint8, device="cuda"))
    frame = chw if layout == "chw" else chw.permute(1, 2, 0).contiguous()
    _equal(scan2d.sat_scan(frame, in_layout=layout), scan2d.sat_scan_plain(chw))
    del chw, frame
    torch.cuda.empty_cache()


@pytest.mark.parametrize("gaze", CENTERS)
def test_select_rows_tiled(pipe, gaze):
    """K6 over three column tiles at 70000x256 with the gaze's row taps."""
    h, w = TILED
    pyc, pymc = _row_taps(h, w, gaze)
    rcw = _sat_frame(h, w, 41).permute(1, 0, 2).contiguous()
    for g, w_ in zip(fs.sat_select_rows(rcw, pyc, pymc),
                     fs.sat_select_rows_plain(rcw, pyc, pymc)):
        _equal(g, w_)


@pytest.mark.parametrize("layout", ["hwc", "chw"])
def test_sat_build_36000_columns(pipe, layout):
    """K5 past the 32,768 columns one block spans: two tiles at
    36000x1024 (the second 3,232 columns)."""
    plan = scan2d.sat_plan(1024, 36000, column_stride=1 if layout == "chw" else 3)
    assert (plan.tiles, plan.chunks_per_thread) == (2, 4)
    chw = _sat_frame(1024, 36000, 42)
    frame = chw if layout == "chw" else chw.permute(1, 2, 0).contiguous()
    _equal(scan2d.sat_scan(frame, in_layout=layout), scan2d.sat_scan_plain(chw))
    del chw, frame
    torch.cuda.empty_cache()


@pytest.mark.parametrize("gazes", [[(0.5, 0.5)], [(0.999, 0.001), (0.0, 0.0), (0.3, 0.7)]],
                         ids=["centre", "batch"])
def test_xy_and_unwarp_at_16k(pipe, gazes):
    """``segreduce_xy`` (99,520 bytes of shared memory a block, above the
    48 KB default) and ``unwarp_xy`` at 15360x8640 -> 8544x4800 against
    their plain versions."""
    p16 = FoveationPipeline(FoveaxConfig().with_source(15360, 8640))
    assert sr.xy_shared_bytes(15360, 8544) == 99_520 and p16.sampler == "fused"
    frame = _sat_frame(8640, 15360, 16)
    args = _xy_args(p16.grid, frame, gazes)
    got = sr.segment_reduce_xy_batch(*args)
    _equal(got, sr.segment_reduce_xy_batch_plain(*args))
    c = torch.tensor(gazes[0], dtype=torch.float32, device="cuda")
    xv, yv = uw.fused_vectors(4800, 8544, 15360, 8640, c)
    _equal(uw.unwarp_xy(got[0], xv, yv), uw.unwarp_xy_plain(got[0], xv, yv))
    del frame, args, got
    torch.cuda.empty_cache()


def test_soak_on_card(pipe):
    """The serving soak on the card: no residue, and the CUDA memory held
    by tensors after each later cycle no higher than after the second,
    when both shapes have warmed up."""
    report = soak.churn("cuda", "jpeg")
    assert soak.residue(report) == []
    assert all(m <= report.memory[1] for m in report.memory[2:]), report.memory


def _select_lists(h: int):
    r = scan2d.BAND_ROWS
    last = -(-h // r) - 1  # the last band
    return {
        "n=1": ([h // 2], [h // 3]),
        "first-and-last-band": ([0, 1, r - 1, last * r, h - 1],
                                [0, 0, 2, last * r + 1, h - 2]),
        "duplicates-straddle-band": ([r - 1, r - 1, r, r, r, 2 * r - 1],
                                     [r - 2, r - 1, r - 1, r, r, r]),
        "max-far-above": ([1, 2, h - 1], [0, 1, 3]),
    }


@pytest.mark.parametrize("case", list(_select_lists(300)))
def test_select_rows_lists(pipe, case):
    h, w = 300, 1001
    pyc, pymc = _select_lists(h)[case]
    rcw = _sat_frame(h, w, 21).permute(1, 0, 2).contiguous()
    pyc = torch.tensor(pyc, dtype=torch.int32, device="cuda")
    pymc = torch.tensor(pymc, dtype=torch.int32, device="cuda")
    for g, w_ in zip(fs.sat_select_rows(rcw, pyc, pymc),
                     fs.sat_select_rows_plain(rcw, pyc, pymc)):
        _equal(g, w_)


@pytest.mark.parametrize("case", list(_select_lists(300)))
def test_select_rows_lists_tiled(pipe, case):
    """The hand-made lists over three column tiles of a 70000-column
    frame (the last tile 4,464 columns)."""
    h, w = 300, TILED[1]
    pyc, pymc = _select_lists(h)[case]
    rcw = _sat_frame(h, w, 22).permute(1, 0, 2).contiguous()
    pyc = torch.tensor(pyc, dtype=torch.int32, device="cuda")
    pymc = torch.tensor(pymc, dtype=torch.int32, device="cuda")
    for g, w_ in zip(fs.sat_select_rows(rcw, pyc, pymc),
                     fs.sat_select_rows_plain(rcw, pyc, pymc)):
        _equal(g, w_)


@pytest.mark.parametrize("batch_sampler", [None, "fused", "sat", "direct"],
                         ids=["session", "broadcast-fused", "broadcast-sat",
                              "broadcast-direct"])
def test_serve_loopback_on_card(pipe, batch_sampler):
    """The port's server and client on the card at 1920x1080 -> 1072x608
    through chip_smoke.py's in-memory connection pair: the served reduced
    and restored frames equal to the CPU pipeline's (tolerance 0) and the
    kernels launched once per served frame or tick."""
    if "h264" not in available_wire_codecs():
        pytest.importorskip("cv2")  # wire_codec="auto" is then jpeg
    kernels = chip_smoke.kernel_table()
    cfg = FoveaxConfig()
    if batch_sampler is None:
        _, client, launches = chip_smoke.serve_session(cfg, "cuda", kernels)
        clients = [client]
    else:
        _, clients, launches = chip_smoke.serve_broadcast(cfg, "cuda", batch_sampler,
                                                          kernels)
    chip_smoke.expect_counts("serve", launches,
                             chip_smoke.serve_expected(batch_sampler, clients))


@pytest.mark.parametrize("mode", ["session", "broadcast"])
def test_svd_serve_loopback_on_card(pipe, mode):
    """The SVD serve mode on the card at 1920x512 -> 1072x288 through
    chip_smoke.py's in-memory pair: SATs, blobs, reduced and restored
    frames equal to the CPU port (tolerance 0); K5 once per source frame,
    ``unwarp_xy`` once per frame restored."""
    kernels = chip_smoke.kernel_table()
    if mode == "session":
        _, client, launches = chip_smoke.serve_svd_session(CFG, "cuda", kernels)
        clients, builds = [client], chip_smoke.SVD_FRAMES
    else:
        _, clients, launches = chip_smoke.serve_svd_broadcast(CFG, "cuda", kernels)
        builds = chip_smoke.SVD_TICKS
    chip_smoke.expect_counts("svd", launches, chip_smoke.svd_expected(clients, builds))


def test_math_on_card(pipe):
    """chip_smoke.py's phase 7 at 1920x512 -> 1072x288 (gnomonic
    640x360): the integer math bit-equal to the CPU port, the float math
    inside its stated bounds."""
    report = chip_smoke.phase_math("cuda", CFG, (640, 360))
    assert all(report[name]["equal"] for name in (
        "sample_rect_point", "sample_rect_360_from_sat", "expand_sampled_rect",
        "sample_logpolar", "build_pyramid", "sample_logpolar_pyramid"))


CLI_SOURCE = "synthetic://1920x512@30/6"


@pytest.mark.parametrize("what", ["single_frame", "foveate_no_encoding"])
def test_cli_on_card_equals_cpu(pipe, tmp_path, what):
    """The CLI on the card at 1920x512 -> 1072x288 against ``--device
    cpu`` on the same source: PNGs byte-equal, transcoded frames equal;
    ``segreduce_xy`` once per frame, no unwarp kernel (the transcode
    restores through the exact unwarp)."""
    kernels = chip_smoke.kernel_table()
    if what == "single_frame":
        argv = lambda d: ["single_frame", CLI_SOURCE, "2", f"{d}/sf", "--gaze", "0.37,0.61"]
        frames = 1
    else:
        argv = lambda d: [what, CLI_SOURCE, f"{d}/rt.mp4", "--gaze-trace",
                          "synthetic:1", "--max-frames", "4"]
        frames = 4
    for dev in ("cuda", "cpu"):
        (tmp_path / dev).mkdir()
    chip_smoke.zero_counts(kernels)
    chip_smoke.run_cli(argv(tmp_path / "cuda"), "cuda")
    chip_smoke.expect_counts(what, chip_smoke.read_counts(kernels),
                             {"segreduce_xy": frames})
    chip_smoke.run_cli(argv(tmp_path / "cpu"), "cpu")
    if what == "single_frame":
        for suffix in ("_source.png", "_foveated.png"):
            assert (tmp_path / "cuda" / f"sf{suffix}").read_bytes() == (
                tmp_path / "cpu" / f"sf{suffix}").read_bytes()
    else:
        chip_smoke.same_videos(what, str(tmp_path / "cuda" / "rt.mp4"),
                               str(tmp_path / "cpu" / "rt.mp4"), frames)


@pytest.mark.parametrize("stage", [3, 4, 5, 6])
def test_cli_stage_on_card(pipe, stage):
    """Stages 3-6 of the CLI's ``stages`` on the card at their fixed
    shapes (1080p stream, 4K SAT path with viewport, 8 gazes at 4K, the
    direct sampler at 4K): each passes, with the launch counts
    chip_smoke.py expects of it."""
    from foveax_torch.cli import stages

    kernels = chip_smoke.kernel_table()
    chip_smoke.zero_counts(kernels)
    assert stages.STAGES[stage - 1](device="cuda")
    chip_smoke.expect_counts(f"stage {stage}", chip_smoke.read_counts(kernels),
                             chip_smoke.STAGE_EXPECTED[stage])


def test_direct_sampler_on_card(pipe, frame):
    """The direct sampler on the card: equal to the fused sampler, single
    and batched, with no kernel launched, and no host sync at a fresh gaze
    under ``set_sync_debug_mode("error")``."""
    kernels = chip_smoke.kernel_table()
    direct = FoveationPipeline(CFG, sampler="direct")
    centers = torch.tensor(CENTERS, dtype=torch.float32, device="cuda")
    hwc = frame.permute(1, 2, 0).contiguous()
    want = [pipe.foveate_chw(frame, c) for c in centers]
    want_batch = pipe.sample_batch_fused(hwc, centers)
    fresh = torch.tensor([0.3141, 0.2718], dtype=torch.float32, device="cuda")
    direct.foveate_chw(frame, centers[0])  # index tensors built once
    chip_smoke.zero_counts(kernels)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [direct.foveate_chw(frame, c) for c in centers]
        got_batch = direct.sample_batch_direct(hwc, centers)
        direct.foveate_chw(frame, fresh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    chip_smoke.expect_counts("direct", chip_smoke.read_counts(kernels), {})
    for g, w_ in zip(got, want):
        _equal(g, w_)
    _equal(got_batch, want_batch)


def test_mesh_dryrun_on_card(pipe):
    """``dryrun_multichip(4)`` on the card (chip_smoke.py phase 9): its
    launches (K5 per space block, frame and device; ``segreduce_xy`` per
    data shard) and every output equal to the CPU port's."""
    chip_smoke.mesh_dryrun(chip_smoke.kernel_table(), "cuda")


def _card_mesh():
    from foveax_torch.parallel import make_mesh

    devices, _ = chip_smoke.mesh_devices("cuda")
    return make_mesh(chip_smoke.MESH_SPACE, chip_smoke.MESH_DATA, devices=devices)


def test_mesh_calls_on_card(pipe):
    """Phase 9's sharded calls at 1920x512 -> 1072x288 over the 2x2 mesh:
    ``sharded_build_sat``, ``multi_client_step``,
    ``frame_parallel_roundtrip``, ``sharded_sample_batch_fused`` and both
    serve pairs, each with its launches (K5 one per space block or frame,
    ``segreduce_xy`` one per data shard, no unwarp kernel) and equal to
    the single-device path on the card and to the CPU port."""
    chip_smoke.mesh_calls(chip_smoke.kernel_table(), CFG, "cuda", _card_mesh())


@pytest.mark.parametrize("batch_sampler", ["fused", "sat"])
def test_mesh_serve_on_card(pipe, batch_sampler):
    """The broadcast ``FoveaxServer(mesh=...)`` on the card at 1920x512
    -> 1072x288: every served and restored frame equal to the CPU path;
    one launch a data shard a served tick (fused) or a space block a tick
    (SAT)."""
    if "h264" not in available_wire_codecs():
        pytest.importorskip("cv2")  # wire_codec="auto" is then jpeg
    chip_smoke.mesh_serve(chip_smoke.kernel_table(), CFG, "cuda", _card_mesh(),
                          batch_sampler)


def test_round_robin_serve_on_card(pipe):
    """Two videos on a ``round_robin`` broadcast server on the card: each
    channel's pipeline on the next visible card (cuda:0 and cuda:1 where
    two are visible), every frame equal to the CPU path, one fused launch
    a served tick per channel."""
    launches, expected, placed = chip_smoke.serve_round_robin(
        CFG, "cuda", chip_smoke.kernel_table())
    chip_smoke.expect_counts("round_robin", launches, expected)
    assert len(placed) == min(2, torch.cuda.device_count())


@pytest.mark.parametrize("fill", ["all-255", "noise-200-255"])
def test_sat_tick_wraps_at_8k(pipe, fill):
    """The serve tick over ``batch_pair("sat")`` at 7680x4320 -> 4272x2400
    with 8 gazes (the wrap seam, both poles), as the benchmark's
    ``equirect8k_sat`` cell runs it, on frames whose every channel total
    passes 2^32, so the uint32 SAT wraps: the reduced frames equal
    ``BoxFilter``'s, whose int64 sums never wrap (tolerance 0), with one
    K5 and one K7 launch."""
    w, h, wr, hr = 7680, 4320, 4272, 2400
    if fill == "all-255":
        frame = np.full((h, w, 3), 255, np.uint8)
    else:
        frame = np.random.default_rng(2**31 + 29).integers(200, 256, (h, w, 3), dtype=np.uint8)
    assert (frame.reshape(-1, 3).sum(0, dtype=np.int64) >= 2**32).all()
    gazes = [(0.0, 0.5), (0.999, 0.5), (0.5, 0.0), (0.5, 0.999), (0.02, 0.02), (0.98, 0.98),
             (0.5, 0.5), (0.31, 0.77)]
    p = FoveationPipeline(FoveaxConfig(source_width=w, source_height=h, reduced_width=wr,
                                       reduced_height=hr))
    tick = ServeTick(p, p.batch_pair("sat"))
    builds, samples = scan2d.SAT_BUILD.launches, ss.SAT_SAMPLE.launches
    got = tick.sample(tick.prepare(frame), gazes)
    assert (scan2d.SAT_BUILD.launches - builds, ss.SAT_SAMPLE.launches - samples) == (1, 1)
    assert got.shape == (8, hr, wr, 3)
    box = BoxFilter(w, h, wr, hr)
    f = torch.from_numpy(frame).cuda()
    off = [int((box(f, g, key=0) != torch.from_numpy(got[v]).cuda()).sum())
           for v, g in enumerate(gazes)]
    print(f"{fill}: reduced bytes off per gaze {off}")
    assert off == [0] * 8


def test_channel_1080p_32_on_card(pipe):
    """The serve tick over ``batch_pair("auto")`` at the ``ref1080p``
    deployment's 1920x1080 -> 1072x608 with a channel's 32 gazes (28 from
    the ``broadcast32`` gaze model, both sides of the wrap seam, both
    poles), as the benchmark's ``ref1080p.broadcast32`` cell runs it: one
    ``segreduce_xy`` launch, and the reduced frames equal the plain twin's
    (the same tick on the CPU, tolerance 0)."""
    root = Path(__file__).resolve().parents[1]
    traffic = json.loads((root / "benchmark/traffic/broadcast32.json").read_text())
    trace = gaze_trace(np.random.default_rng(2**31 + 28), 28, traffic["gaze"])
    gazes = [tuple(map(float, g)) for g in trace[28]]
    gazes += [(0.0, 0.5), (0.999, 0.5), (0.5, 0.0), (0.5, 0.999)]
    assert len(gazes) == traffic["viewers"] == 32
    cfg = FoveaxConfig(source_width=1920, source_height=1080, reduced_width=1072,
                       reduced_height=608)
    frame = np.random.default_rng(2**31 + 28).integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    out = {}
    for device in ("cuda", "cpu"):
        p = FoveationPipeline(cfg, device=device)
        assert p.sampler == "fused"
        tick = ServeTick(p, p.batch_pair("auto"))
        launches = sr.XY_PASS.launches
        out[device] = tick.sample(tick.prepare(frame), gazes)
        if device == "cuda":
            assert sr.XY_PASS.launches - launches == 1
    assert out["cuda"].shape == (32, 608, 1072, 3)
    np.testing.assert_array_equal(out["cuda"], out["cpu"])
