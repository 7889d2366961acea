"""The CUDA kernels of foveax_torch on the card: each wrapper against its
plain version (tolerance 0, the SAT compared through its int32 view), its
input checks and its launch count; the SAT pipeline against the fused one;
the streaming server and client on the card.

These tests need a CUDA device and skip without one.  On the card, run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which the port's
machine does not need)."""

import numpy as np
import pytest
import torch

import chip_smoke
from foveax_torch import FoveaxConfig, FoveationPipeline
from foveax_torch.io.wirecodec import available_wire_codecs
from foveax_torch.kernels import fused_select as fs
from foveax_torch.kernels import scan2d
from foveax_torch.kernels import segreduce as sr
from foveax_torch.kernels import unwarp as uw

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
    before = scan2d.SAT_BUILD.launches
    got = pipe.foveate(frame.cuda(), pipe.center(0.3, 0.6))
    torch.cuda.synchronize()
    assert scan2d.SAT_BUILD.launches == before + 1
    cpu = FoveationPipeline(small, device="cpu")
    assert torch.equal(got.cpu(), cpu.foveate(frame, cpu.center(0.3, 0.6)))
    # Its delta steps exceed 255: "auto" unwarps exactly, with no kernel.
    chw = frame.permute(2, 0, 1).contiguous()
    before = (scan2d.SAT_BUILD.launches, uw.UNWARP_XY.launches)
    c = pipe.center(0.3, 0.6)
    out = pipe.unwarp_auto_chw(pipe.foveate_chw(chw.cuda(), c), c)
    torch.cuda.synchronize()
    assert (scan2d.SAT_BUILD.launches, uw.UNWARP_XY.launches) == (
        before[0] + 1, before[1]
    )
    c = cpu.center(0.3, 0.6)
    assert torch.equal(out.cpu(), cpu.unwarp_auto_chw(cpu.foveate_chw(chw, c), c))


def test_sat_launches_count_once(pipe, frame):
    c = pipe.center(0.5, 0.5)
    sat_pipe = FoveationPipeline(CFG, sampler="sat")
    before = (scan2d.SAT_BUILD.launches, fs.SELECT_ROWS.launches)
    sat_pipe.foveate_chw(frame, c)
    idx = torch.arange(0, 512, 7, dtype=torch.int32, device="cuda")
    fs.sat_select_rows(frame.permute(1, 0, 2).contiguous(), idx, idx)
    torch.cuda.synchronize()
    assert scan2d.SAT_BUILD.launches - before[0] == 1
    assert fs.SELECT_ROWS.launches - before[1] == 1


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


@pytest.mark.parametrize("batch_sampler", [None, "fused", "sat"],
                         ids=["session", "broadcast-fused", "broadcast-sat"])
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


@pytest.mark.parametrize("stage", [3, 4, 5])
def test_cli_stage_on_card(pipe, stage):
    """Stages 3-5 of the CLI's ``stages`` on the card at their fixed
    shapes (1080p stream, 4K SAT path with viewport, 8 gazes at 4K): each
    passes, with the launch counts chip_smoke.py expects of it."""
    from foveax_torch.cli import stages

    kernels = chip_smoke.kernel_table()
    chip_smoke.zero_counts(kernels)
    assert stages.STAGES[stage - 1](device="cuda")
    chip_smoke.expect_counts(f"stage {stage}", chip_smoke.read_counts(kernels),
                             chip_smoke.STAGE_EXPECTED[stage])
