"""The port's SAT-free direct sampler (``foveax_torch.core.direct``) on the
CPU against foveax's ``sample_rect_direct`` (jitted), the port's SAT
sampler and ``golden.sample_rect``, on the same numpy frames.

Tolerance 0 everywhere: every sampler computes the same integers.  At
1920x1080 -> 64x36 foveax's direct sampler is not the reference (its
band windows assume grid steps of at most 23 and miss there, ROADMAP
Queue 3, F2): the port is held to the float64 golden and its SAT sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foveax.core import golden
from foveax.core.direct import _axis_bands as fx_axis_bands
from foveax.core.direct import sample_rect_direct as fx_direct
from foveax.core.direct import sample_rect_direct_batch as fx_direct_batch
from foveax.core.logrect import _grid_axis as fx_grid_axis
from foveax.core.logrect import make_grid as fx_make_grid
from foveax_torch import FoveaxConfig, FoveationPipeline
from foveax_torch.core import direct
from foveax_torch.core.logrect import _grid_axis, make_grid
from foveax_torch.core.sample import sample_rect_from_sat
from foveax_torch.core.sat import build_sat

torch.set_num_threads(1)

SRC_W, SRC_H, OUT_W, OUT_H = 256, 192, 144, 112

# tests/test_direct.py's gazes.
CENTERS = [
    (0.5, 0.5), (0.1, 0.2), (0.9, 0.8), (0.02, 0.5), (0.98, 0.5), (0.0, 0.0),
    (1.0, 1.0), (0.5, 0.02), (0.5, 0.98), (0.0, 1.0), (1.0, 0.0),
]
# The gazes of F2 at 1920x1080 -> 64x36.
F2_GAZES = [(0.5, 0.5), (0.0, 0.0), (1.0, 1.0), (0.98, 0.03)]


def _c(center) -> torch.Tensor:
    return torch.tensor(center, dtype=torch.float32)


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(7)
    frame = rng.integers(0, 256, (SRC_H, SRC_W, 3), np.uint8)
    fr = jnp.asarray(frame.transpose(2, 0, 1))
    fx_grid = fx_make_grid(OUT_W, OUT_H, SRC_W, SRC_H)
    fx_fn = jax.jit(
        lambda c, w: fx_direct(fr, fx_grid, c, wrap_x=w), static_argnums=1
    )
    return dict(
        frame=frame,
        chw=torch.from_numpy(frame.transpose(2, 0, 1).copy()),
        grid=make_grid(OUT_W, OUT_H, SRC_W, SRC_H, "cpu"),
        fx=lambda c, w: np.asarray(fx_fn(jnp.asarray(c, jnp.float32), w)),
        fx_grid=fx_grid,
    )


def _merged(bands):
    """foveax's bands with its matmul sub-bands of one periphery run merged
    into one box band: (kind, start, end) triples."""
    out = []
    for b in bands:
        kind = "box" if b.kind == "mm" else b.kind
        if out and out[-1][0] == kind == "box":
            out[-1] = (kind, out[-1][1], b.end)
        else:
            out.append((kind, b.start, b.end))
    return out


@pytest.mark.parametrize(
    "dims",
    [(1072, 608, 1920, 1080), (2144, 1200, 3840, 2160),
     (4272, 2400, 7680, 4320), (8544, 4800, 15360, 8640),
     (OUT_W, OUT_H, SRC_W, SRC_H)],
    ids=["1080p", "4k", "8k", "16k", "testsize"],
)
def test_axis_bands_match_foveax(dims):
    """The band split of both axes is foveax's: the same crop band, and
    the same periphery runs around it (foveax cuts each into sub-bands of
    one matmul slab width; the port has no slabs)."""
    out_w, out_h, src_w, src_h = dims
    for out_dim, src_dim in ((out_w, src_w), (out_h, src_h)):
        g = _grid_axis(out_dim, src_dim).astype(np.int64).tobytes()
        assert g == fx_grid_axis(out_dim, src_dim).astype(np.int64).tobytes()
        got = [(b.kind, b.start, b.end) for b in direct._axis_bands(g, src_dim)]
        assert got == _merged(fx_axis_bands(g, src_dim))
        assert [k for k, *_ in got].count("crop") == 1


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("center", CENTERS)
def test_matches_foveax(small, center, wrap):
    got = direct.sample_rect_direct(small["chw"], small["grid"], _c(center), wrap_x=wrap)
    np.testing.assert_array_equal(got.numpy(), small["fx"](center, wrap))


@pytest.mark.parametrize("axis", ["x", "y"])
def test_matches_foveax_every_integer_gaze(small, axis):
    """Every integer cx at cy 0.3 (every seam straddle and clamp phase of
    the x bands), and every integer cy at cx 0.4."""
    n = SRC_W if axis == "x" else SRC_H
    for k in range(n + 1):
        center = (k / n, 0.3) if axis == "x" else (0.4, k / n)
        got = direct.sample_rect_direct(small["chw"], small["grid"], _c(center))
        assert np.array_equal(got.numpy(), small["fx"](center, True)), (axis, k)


@pytest.fixture(scope="module")
def flagship():
    rng = np.random.default_rng(11)
    frame = rng.integers(0, 256, (1080, 1920, 3), np.uint8)
    fx_grid = fx_make_grid(1072, 608, 1920, 1080)
    fx_fn = jax.jit(lambda f, c: fx_direct(f, fx_grid, c))
    chw = torch.from_numpy(frame.transpose(2, 0, 1).copy())
    return dict(
        chw=chw,
        grid=make_grid(1072, 608, 1920, 1080, "cpu"),
        sat=build_sat(chw, in_layout="chw"),
        fx=lambda c: np.asarray(
            fx_fn(jnp.asarray(frame.transpose(2, 0, 1)), jnp.asarray(c, jnp.float32))
        ),
    )


@pytest.mark.parametrize("center", [(0.5, 0.5), (0.98, 0.03), (0.0, 1.0)])
def test_flagship_1080p(flagship, center):
    """1920x1080 -> 1072x608: equal to foveax's direct sampler and to the
    port's SAT sampler."""
    got = direct.sample_rect_direct(flagship["chw"], flagship["grid"], _c(center))
    np.testing.assert_array_equal(got.numpy(), flagship["fx"](center))
    want = sample_rect_from_sat(flagship["sat"], flagship["grid"], _c(center))
    assert torch.equal(got, want)


def test_layouts_agree(small):
    grid, c = small["grid"], _c((0.3, 0.6))
    hwc_in = torch.from_numpy(small["frame"])
    ref = direct.sample_rect_direct(small["chw"], grid, c, out_layout="chw")
    for in_layout, frame in (("chw", small["chw"]), ("hwc", hwc_in)):
        chw = direct.sample_rect_direct(frame, grid, c, in_layout=in_layout, out_layout="chw")
        hwc = direct.sample_rect_direct(frame, grid, c, in_layout=in_layout)
        assert torch.equal(chw, ref)
        assert torch.equal(hwc, ref.permute(1, 2, 0))


def test_batch_matches_loop_and_sat_batch(small):
    """The batch form equals the per-gaze loop, the port's SAT batch and
    foveax's ``sample_rect_direct_batch``, in both layouts."""
    grid = small["grid"]
    gazes = [[0.5, 0.5], [0.02, 0.3], [0.98, 0.9], [1.0, 0.0], [0.2, 0.3]]
    centers = torch.tensor(gazes, dtype=torch.float32)
    hwc_in = torch.from_numpy(small["frame"])
    batch = direct.sample_rect_direct_batch(hwc_in, grid, centers, in_layout="hwc")
    for i, c in enumerate(centers):
        assert torch.equal(batch[i], direct.sample_rect_direct(small["chw"], grid, c))
    sat = build_sat(hwc_in)
    assert torch.equal(batch, sample_rect_from_sat(sat, grid, centers))
    chw = direct.sample_rect_direct_batch(small["chw"], grid, centers, out_layout="chw")
    assert torch.equal(chw, batch.permute(0, 3, 1, 2))
    want = fx_direct_batch(
        jnp.asarray(small["frame"]), small["fx_grid"], jnp.asarray(gazes, jnp.float32),
        in_layout="hwc",
    )
    np.testing.assert_array_equal(batch.numpy(), np.asarray(want))


@pytest.mark.parametrize("fill", ["random", "all-255"])
@pytest.mark.parametrize("center", F2_GAZES)
def test_f2_shape_matches_golden(center, fill):
    """1920x1080 -> 64x36 (y row steps up to 268, one periphery band on
    y): equal to ``golden.sample_rect`` and to the port's SAT sampler,
    where foveax's direct sampler misses (F2)."""
    if fill == "random":
        frame = np.random.default_rng(0).integers(0, 256, (1080, 1920, 3), np.uint8)
    else:
        frame = np.full((1080, 1920, 3), 255, np.uint8)
    want = golden.sample_rect(
        golden.build_sat(frame), golden.grid_dense(64, 36, 1920, 1080), center
    )
    grid = make_grid(64, 36, 1920, 1080, "cpu")
    hwc = torch.from_numpy(frame)
    got = direct.sample_rect_direct(hwc, grid, _c(center), in_layout="hwc")
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, sample_rect_from_sat(build_sat(hwc), grid, _c(center)))


def test_moving_gaze_rebuilds_nothing(small):
    """Bands and index tensors are built once per grid and device; a
    moving gaze adds no cache entry."""
    grid = small["grid"]
    direct.sample_rect_direct(small["chw"], grid, _c((0.5, 0.5)))
    before = (direct._axis_bands.cache_info().misses,
              direct._axis_split.cache_info().misses)
    for c in [(0.1, 0.9), (0.77, 0.23), (0.0, 1.0)]:
        direct.sample_rect_direct(small["chw"], grid, _c(c))
    assert (direct._axis_bands.cache_info().misses,
            direct._axis_split.cache_info().misses) == before


def test_direct_runs_no_sat_and_no_fused_sampler(small, monkeypatch):
    """``sampler="direct"`` and ``batch_pair("direct")`` reach neither the
    SAT build nor the fused sampler (every entry replaced by one that
    raises), and equal the SAT pipeline."""
    from foveax_torch.core import sat as core_sat
    from foveax_torch.kernels import scan2d
    from foveax_torch.kernels import segreduce as sr
    from foveax_torch.pipeline import frames

    cfg = FoveaxConfig(source_width=SRC_W, source_height=SRC_H,
                       reduced_width=OUT_W, reduced_height=OUT_H)
    pipe = FoveationPipeline(cfg, sampler="direct", device="cpu")
    sat_pipe = FoveationPipeline(cfg, sampler="sat", device="cpu")
    frame = torch.from_numpy(small["frame"])
    centers = torch.tensor(CENTERS[:4], dtype=torch.float32)
    want_one = sat_pipe.foveate(frame, centers[1])
    want_batch = sat_pipe.foveate_batch(frame, centers)

    def refuse(*args, **kw):
        raise AssertionError("the direct path reached a SAT or fused entry")

    for mod, names in ((frames, ("build_sat", "sample_rect_fused", "sample_rect_fused_batch")),
                       (sr, ("sample_rect_fused", "sample_rect_fused_batch",
                             "segment_reduce_xy_batch", "segment_reduce_xy_batch_plain")),
                       (core_sat, ("build_sat", "sat_scan")),
                       (scan2d, ("sat_scan", "sat_scan_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    assert pipe.sampler == "direct"
    assert torch.equal(pipe.foveate(frame, centers[1]), want_one)
    chw = frame.permute(2, 0, 1).contiguous()
    assert torch.equal(pipe.foveate_chw(chw, centers[1]), want_one.permute(2, 0, 1))
    prepare, sample_batch = pipe.batch_pair("direct")
    assert torch.equal(sample_batch(prepare(frame), centers), want_batch)
    prepare, sample = pipe.single_pair()
    assert torch.equal(sample(prepare(frame), centers[1]), want_one)


def test_chip_smoke_phase_direct_on_cpu(monkeypatch):
    """chip_smoke.py's phase 10 at small shapes on the CPU (no launch
    counts, no timing): the 32-frame direct paths with each reduced frame
    equal to the fused pipeline's and the fovea round-tripped, the batch
    pair equal to the fused batch, F2's shape equal to the SAT path."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "SHAPES", {"1080p": (192, 108), "4k": (384, 216)})
    report = chip_smoke.phase_direct(None, device="cpu")
    assert set(report) == {"path 1080p", "path 4k", "batch pair"}
