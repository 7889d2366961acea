"""foveax_torch's fused sampler (plain versions of kernels K1/K2 on the
CPU) against foveax: bit-identical to ``sample_rect_fused`` in interpret
mode, to the SAT path and to the float64 golden.

The JAX references are jitted with the gaze traced, so each shape and
wrap mode compiles once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foveax.core import golden
from foveax.core.logrect import make_grid as fx_make_grid
from foveax.core.sample import _axis_taps as fx_axis_taps
from foveax.core.sample import sample_rect_from_sat
from foveax.core.sat import build_sat
from foveax.kernels.segreduce import sample_rect_fused as fx_fused
from foveax.kernels.segreduce import sample_rect_fused_batch as fx_fused_batch
from foveax_torch.convert import grid_from_numpy
from foveax_torch.core.sample import _axis_taps
from foveax_torch.kernels import segreduce
from foveax_torch.kernels.segreduce import (
    sample_rect_fused,
    sample_rect_fused_batch,
)

torch.set_num_threads(1)

# The shape tests/test_segreduce.py proves eligible for the fused kernels.
SRC_W, SRC_H, OUT_W, OUT_H = 1920, 512, 1072, 288

CENTERS = [
    (0.5, 0.5),
    (0.03, 0.4),
    (0.97, 0.6),
    (0.0, 0.0),
    (1.0, 1.0),
    (0.31, 0.87),
    (0.999, 0.001),
    (0.0, 1.0),
]


def _grids(out_w, out_h, src_w, src_h):
    grid = fx_make_grid(out_w, out_h, src_w, src_h)
    tgrid = grid_from_numpy(
        np.asarray(grid.gx), np.asarray(grid.gy), out_w, out_h, src_w, src_h,
        "cpu",
    )
    return grid, tgrid


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 256, (SRC_H, SRC_W, 3), np.uint8)
    grid, tgrid = _grids(OUT_W, OUT_H, SRC_W, SRC_H)
    fused = {
        wrap: jax.jit(
            lambda fr, c, wrap=wrap: fx_fused(
                fr, grid, c, wrap_x=wrap, out_layout="chw", interpret=True
            )
        )
        for wrap in (True, False)
    }
    sat_path = {
        wrap: jax.jit(
            lambda sat, c, wrap=wrap: sample_rect_from_sat(
                sat, grid, c, wrap_x=wrap, out_layout="chw"
            )
        )
        for wrap in (True, False)
    }
    return dict(
        frame=frame,
        frame_chw=np.ascontiguousarray(frame.transpose(2, 0, 1)),
        sat=build_sat(jnp.asarray(frame)),
        grid=grid,
        tgrid=tgrid,
        fused=fused,
        sat_path=sat_path,
    )


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("center", CENTERS)
def test_sampler_matches_fused_and_sat(setup, center, wrap):
    c = jnp.asarray(center, jnp.float32)
    got = sample_rect_fused(
        torch.from_numpy(setup["frame_chw"]), setup["tgrid"],
        torch.tensor(center, dtype=torch.float32), wrap_x=wrap,
        out_layout="chw",
    ).numpy()
    fused = np.asarray(setup["fused"][wrap](jnp.asarray(setup["frame_chw"]), c))
    sat = np.asarray(setup["sat_path"][wrap](setup["sat"], c))
    np.testing.assert_array_equal(got, fused)
    np.testing.assert_array_equal(got, sat)


def test_sampler_matches_golden(setup):
    center = (0.37, 0.62)
    ref = golden.sample_rect(
        golden.build_sat(setup["frame"]),
        golden.grid_dense(OUT_W, OUT_H, SRC_W, SRC_H),
        center,
    )
    got = sample_rect_fused(
        torch.from_numpy(setup["frame"]), setup["tgrid"],
        torch.tensor(center, dtype=torch.float32), in_layout="hwc",
    ).numpy()
    np.testing.assert_array_equal(got, ref)


def test_sampler_layouts(setup):
    c = torch.tensor((0.4, 0.7), dtype=torch.float32)
    hwc = sample_rect_fused(
        torch.from_numpy(setup["frame"]), setup["tgrid"], c, in_layout="hwc"
    )
    chw = sample_rect_fused(
        torch.from_numpy(setup["frame_chw"]), setup["tgrid"], c,
        out_layout="chw",
    )
    assert hwc.shape == (OUT_H, OUT_W, 3) and hwc.dtype == torch.uint8
    np.testing.assert_array_equal(hwc.numpy(), chw.numpy().transpose(1, 2, 0))


def test_batch_matches_fused_batch(setup):
    """One launch set for N gazes equals foveax's batch API (hwc out)."""
    centers = np.asarray([(0.5, 0.5), (0.03, 0.4), (0.999, 0.001)], np.float32)
    grid = setup["grid"]
    ref = jax.jit(
        lambda fr, cs: fx_fused_batch(fr, grid, cs, interpret=True)
    )(jnp.asarray(setup["frame_chw"]), jnp.asarray(centers))
    got = sample_rect_fused_batch(
        torch.from_numpy(setup["frame_chw"]), setup["tgrid"],
        torch.from_numpy(centers),
    )
    assert got.shape == (3, OUT_H, OUT_W, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    chw = sample_rect_fused_batch(
        torch.from_numpy(setup["frame"]), setup["tgrid"],
        torch.from_numpy(centers), in_layout="hwc", out_layout="chw",
    )
    np.testing.assert_array_equal(
        chw.numpy(), np.asarray(ref).transpose(0, 3, 1, 2)
    )


@pytest.fixture(scope="module")
def setup_1080p():
    rng = np.random.default_rng(5)
    grid, tgrid = _grids(1072, 608, 1920, 1080)
    fused = jax.jit(
        lambda fr, c: fx_fused(fr, grid, c, out_layout="chw", interpret=True)
    )
    return rng.integers(0, 256, (3, 1080, 1920), np.uint8), tgrid, fused


@pytest.mark.parametrize("center", [(0.37, 0.62), (0.999, 0.001)])
def test_sampler_1080p(setup_1080p, center):
    frame, tgrid, fused = setup_1080p
    ref = fused(jnp.asarray(frame), jnp.asarray(center, jnp.float32))
    got = sample_rect_fused(
        torch.from_numpy(frame), tgrid, torch.tensor(center), out_layout="chw"
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize(
    "axis, wrap", [("x", True), ("x", False), ("y", False)]
)
def test_axis_taps_all_integer_gazes_1080p(axis, wrap):
    """(pc, pmc, valid) for every integer scaled centre of the axis."""
    grid, tgrid = _grids(1072, 608, 1920, 1080)
    g, tg, dim = (
        (grid.gx, tgrid.gx, 1920) if axis == "x" else (grid.gy, tgrid.gy, 1080)
    )
    cs = np.arange(dim + 1, dtype=np.int32)
    ref = jax.jit(
        jax.vmap(lambda c: fx_axis_taps(g, c, dim, wrap=wrap)[:3])
    )(jnp.asarray(cs))
    got = _axis_taps(tg, torch.from_numpy(cs)[:, None], dim, wrap=wrap)
    for r, t in zip(ref, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))


def test_y_pass_plain_sums_rows():
    """K1's plain version against a direct numpy sum per interval."""
    rng = np.random.default_rng(8)
    frame = rng.integers(0, 256, (3, 40, 24), np.uint8)
    pc = rng.integers(1, 40, (2, 9)).astype(np.int32)
    pmc = (pc - 1 - rng.integers(0, 5, (2, 9)).clip(0, pc - 1)).astype(np.int32)
    got = segreduce.y_segment_reduce_batch(
        torch.from_numpy(frame), torch.from_numpy(pmc), torch.from_numpy(pc)
    )
    assert got.dtype == torch.uint16 and got.shape == (2, 3, 9, 24)
    for g in range(2):
        for j in range(9):
            want = frame[:, pmc[g, j] + 1 : pc[g, j] + 1].astype(np.int64).sum(1)
            np.testing.assert_array_equal(got[g, :, j].to(torch.int64), want)


def test_x_pass_plain_divides_exactly():
    """K2's plain version against numpy: floor(box / (dy * dx)), masked."""
    rng = np.random.default_rng(9)
    n, hr, w, wr = 2, 5, 30, 7
    rows = rng.integers(0, 255 * 4, (n, 3, hr, w)).astype(np.uint16)
    pxc = rng.integers(1, w, (n, wr)).astype(np.int32)
    pxmc = (pxc - 1 - rng.integers(0, 4, (n, wr)).clip(0, pxc - 1)).astype(
        np.int32
    )
    pyc = np.full((n, hr), 4, np.int32)
    pymc = np.zeros((n, hr), np.int32)
    vx = rng.random((n, wr)) > 0.2
    vy = rng.random((n, hr)) > 0.2
    t = torch.from_numpy
    got = segreduce.x_segment_reduce_batch(
        t(rows), t(pxmc), t(pxc), t(vx), t(pymc), t(pyc), t(vy)
    ).numpy()
    for g in range(n):
        for i in range(wr):
            box = rows[g, :, :, pxmc[g, i] + 1 : pxc[g, i] + 1].astype(
                np.int64
            ).sum(-1)
            want = box // (4 * (pxc[g, i] - pxmc[g, i]))
            want = np.where(vy[g][None, :] & vx[g, i], want, 0)
            np.testing.assert_array_equal(got[g, :, :, i], want)


def test_ineligible_grid_raises():
    """Row steps too large for the uint16 row sums raise, as foveax's
    structural contract does."""
    gx = np.arange(9, dtype=np.int16) * 2 - 8
    gy = np.asarray([-400, -2, 0, 2, 400], np.int16)  # a 398-row step
    tgrid = grid_from_numpy(gx, gy, 8, 4, 16, 1024, "cpu")
    assert not segreduce.fused_eligible(tgrid)
    frame = torch.zeros((3, 1024, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint16"):
        sample_rect_fused(frame, tgrid, torch.tensor((0.5, 0.5)))
