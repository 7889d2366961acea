"""foveax_torch's samplers against foveax: the fused sampler (on the CPU,
the plain version of ``segment_reduce_xy_batch``: K1's and K2's plain
passes composed) bit-identical to
``sample_rect_fused`` in interpret mode, to the SAT path and to the
float64 golden; the SAT sampler ``sample_rect_from_sat`` bit-identical to
foveax's, with both tap schemes, both wrap modes and a gaze batch; and
the CLI-only samplers (``sample_rect_360_from_sat``,
``expand_sampled_rect``, ``sample_rect_point`` with its point grid)
bit-identical to foveax's and to the golden.

The JAX references are jitted with the gaze traced, so each shape and
wrap mode compiles once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foveax.core import golden
from foveax.core.logrect import make_grid as fx_make_grid
from foveax.core.logrect import make_point_grid as fx_make_point_grid
from foveax.core.sample import expand_sampled_rect as fx_expand
from foveax.core.sample import sample_rect_360_from_sat as fx_sample_360
from foveax.core.sample import sample_rect_point as fx_point
from foveax.core.sample import _axis_taps as fx_axis_taps
from foveax.core.sample import sample_rect_from_sat
from foveax.core.sat import build_sat
from foveax.kernels.segreduce import sample_rect_fused as fx_fused
from foveax.kernels.segreduce import sample_rect_fused_batch as fx_fused_batch
from foveax_torch.config import reduced_dim
from foveax_torch.convert import grid_from_numpy
from foveax_torch.core.logrect import make_grid
from foveax_torch.core.logrect import make_point_grid as t_make_point_grid
from foveax_torch.core.sample import _axis_taps
from foveax_torch.core.sample import expand_sampled_rect as t_expand
from foveax_torch.core.sample import sample_rect_360_from_sat as t_sample_360
from foveax_torch.core.sample import sample_rect_point as t_point
from foveax_torch.core.sample import sample_rect_from_sat as t_sample_sat
from foveax_torch.core.sat import build_sat as t_build_sat
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
        (wrap, taps): jax.jit(
            lambda sat, c, wrap=wrap, taps=taps: sample_rect_from_sat(
                sat, grid, c, wrap_x=wrap, out_layout="chw", taps=taps
            )
        )
        for wrap in (True, False)
        for taps in ("shared", "paired")
    }
    return dict(
        frame=frame,
        frame_chw=np.ascontiguousarray(frame.transpose(2, 0, 1)),
        sat=build_sat(jnp.asarray(frame)),
        tsat=t_build_sat(torch.from_numpy(frame)),
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
    sat = np.asarray(setup["sat_path"][wrap, "shared"](setup["sat"], c))
    np.testing.assert_array_equal(got, fused)
    np.testing.assert_array_equal(got, sat)


@pytest.mark.parametrize("taps", ["shared", "paired"])
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("center", CENTERS)
def test_sat_sampler_matches_foveax(setup, center, wrap, taps):
    want = setup["sat_path"][wrap, taps](
        setup["sat"], jnp.asarray(center, jnp.float32)
    )
    got = t_sample_sat(
        setup["tsat"], setup["tgrid"], torch.tensor(center, dtype=torch.float32),
        wrap_x=wrap, out_layout="chw", taps=taps,
    )
    assert got.dtype == torch.uint8 and got.shape == (3, OUT_H, OUT_W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sat_sampler_batch_matches_foveax(setup):
    """N gazes against one SAT (a leading axis on the centres) equal
    foveax's vmapped sample, in both output layouts."""
    centers = np.asarray(CENTERS, np.float32)
    grid = setup["grid"]
    want = np.asarray(
        jax.jit(
            jax.vmap(lambda c: sample_rect_from_sat(setup["sat"], grid, c))
        )(jnp.asarray(centers))
    )
    got = t_sample_sat(setup["tsat"], setup["tgrid"], torch.from_numpy(centers))
    assert got.shape == (len(CENTERS), OUT_H, OUT_W, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    chw = t_sample_sat(
        setup["tsat"], setup["tgrid"], torch.from_numpy(centers),
        out_layout="chw",
    )
    np.testing.assert_array_equal(chw.numpy(), want.transpose(0, 3, 1, 2))


def test_sat_sampler_rejects_unknown_taps(setup):
    with pytest.raises(ValueError, match="taps"):
        t_sample_sat(
            setup["tsat"], setup["tgrid"], torch.tensor((0.5, 0.5)), taps="direct"
        )


def test_sat_sampler_on_wrapped_sat(setup):
    """Offset by a huge constant mod 2^32, the SAT samples as before: the
    4-tap difference is taken mod 2^32."""
    c = torch.tensor((0.31, 0.87))
    shifted = (setup["tsat"].numpy().astype(np.uint64) + 0xFEDCBA98) % 2**32
    got = t_sample_sat(
        torch.from_numpy(shifted.astype(np.uint32)), setup["tgrid"], c
    )
    want = setup["sat_path"][True, "shared"](setup["sat"], jnp.asarray(c.numpy()))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(want).transpose(1, 2, 0)
    )


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
    sat_path = jax.jit(
        lambda sat, c: sample_rect_from_sat(sat, grid, c, out_layout="chw")
    )
    frame = rng.integers(0, 256, (3, 1080, 1920), np.uint8)
    return frame, tgrid, fused, sat_path


@pytest.mark.parametrize("center", [(0.37, 0.62), (0.999, 0.001)])
def test_sampler_1080p(setup_1080p, center):
    frame, tgrid, fused, _ = setup_1080p
    ref = fused(jnp.asarray(frame), jnp.asarray(center, jnp.float32))
    got = sample_rect_fused(
        torch.from_numpy(frame), tgrid, torch.tensor(center), out_layout="chw"
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("center", [(0.37, 0.62), (0.999, 0.001)])
def test_sat_sampler_1080p(setup_1080p, center):
    frame, tgrid, _, sat_path = setup_1080p
    sat = t_build_sat(torch.from_numpy(frame), in_layout="chw")
    want = sat_path(jnp.asarray(sat.numpy()), jnp.asarray(center, jnp.float32))
    got = t_sample_sat(sat, tgrid, torch.tensor(center), out_layout="chw")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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


def _random_taps(rng, n: int, m: int, dim: int, maxlen: int):
    """(pc, pmc, valid), each (n, m), obeying the clamp rule: intervals of
    1..maxlen in no order, overlapping, the first touching 0 and the last
    dim - 1, about a fifth invalid."""
    pc = rng.integers(1, dim, (n, m))
    pmc = np.maximum(pc - rng.integers(1, maxlen + 1, (n, m)), 0)
    pc[:, 0], pmc[:, 0] = 1, 0
    pc[:, -1], pmc[:, -1] = dim - 1, max(dim - 1 - maxlen, 0)
    valid = rng.random((n, m)) > 0.2
    return pc.astype(np.int32), pmc.astype(np.int32), valid


@pytest.mark.parametrize("n", [1, 3])
def test_xy_pass_plain_is_the_box_mean(n):
    """The fused sampler's one-launch function against a direct numpy box
    sum per cell, on random in-contract taps (tolerance 0)."""
    rng = np.random.default_rng(10 + n)
    h, w, hr, wr = 41, 37, 13, 17
    frame = rng.integers(0, 256, (3, h, w), np.uint8)
    pxc, pxmc, vx = _random_taps(rng, n, wr, w, w - 1)
    pyc, pymc, vy = _random_taps(rng, n, hr, h, h - 1)
    t = torch.from_numpy
    got = segreduce.segment_reduce_xy_batch(
        t(frame), t(pxmc), t(pxc), t(vx), t(pymc), t(pyc), t(vy)
    ).numpy()
    assert got.dtype == np.uint8 and got.shape == (n, 3, hr, wr)
    want = np.zeros_like(got)
    for g in range(n):
        for j in range(hr):
            for i in range(wr):
                if not (vx[g, i] and vy[g, j]):
                    continue
                box = frame[:, pymc[g, j] + 1 : pyc[g, j] + 1,
                            pxmc[g, i] + 1 : pxc[g, i] + 1]
                rect = (pyc[g, j] - pymc[g, j]) * (pxc[g, i] - pxmc[g, i])
                want[g, :, j, i] = box.astype(np.int64).sum((1, 2)) // rect
    np.testing.assert_array_equal(got, want)


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


@pytest.mark.parametrize(
    "w, h, eligible",
    [(36000, 18000, False), (36000, 64, False), (34560, 17280, True),
     (35888, 64, True), (35889, 64, False)],
)
def test_fused_contract_includes_shared_memory(w, h, eligible):
    """The fused sampler's contract includes ``segment_reduce_xy``'s
    shared memory: under the reduced-size rule its block fits the card up
    to 35,888 source columns.  Host arithmetic on the grid's own fields,
    so the CPU holds it as the card would."""
    grid = make_grid(reduced_dim(w), reduced_dim(h), w, h, "cpu")
    smem = segreduce.xy_shared_bytes(w, reduced_dim(w))
    assert (smem <= segreduce.MAX_SHARED_BYTES) == eligible
    assert segreduce.fused_eligible(grid) == eligible
    assert 255 * grid.max_dy < 2**16  # the row-sum bound holds throughout
    if not eligible:
        frame = torch.empty((3, h, w), dtype=torch.uint8, device="meta")
        with pytest.raises(ValueError, match=f"source width {w} .* {smem} bytes"):
            segreduce.fused_taps(grid, frame, torch.zeros((1, 2)))


# -- the CLI-only samplers -------------------------------------------------

CLI_SHAPES = [(96, 64, 48, 32), (256, 128, 144, 80)]


@pytest.fixture(scope="module", params=CLI_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def cli(request):
    w, h, wr, hr = request.param
    frame = np.random.default_rng(w + h).integers(0, 256, (h, w, 3), np.uint8)
    grid, tgrid = _grids(wr, hr, w, h)
    return dict(w=w, h=h, wr=wr, hr=hr, frame=frame, grid=grid, tgrid=tgrid,
                sat=build_sat(jnp.asarray(frame)),
                tsat=t_build_sat(torch.from_numpy(frame)))


@pytest.mark.parametrize("center", CENTERS)
def test_sample_rect_360_bit_equal_to_foveax(cli, center):
    """Bit-equal to foveax everywhere (both zero the texels the reference
    reads past its grid buffer) and to the golden on its ``defined``
    mask, in both layouts."""
    c = jnp.asarray(center, jnp.float32)
    fn = jax.jit(lambda s, c: fx_sample_360(s, cli["grid"], c))
    want = np.asarray(fn(cli["sat"], c))
    tc = torch.tensor(center, dtype=torch.float32)
    got = t_sample_360(cli["tsat"], cli["tgrid"], tc).numpy()
    np.testing.assert_array_equal(got, want)
    gold, defined = golden.sample_rect_360(
        np.asarray(cli["sat"]), golden.grid_dense(cli["wr"], cli["hr"], cli["w"],
                                                  cli["h"]), center)
    np.testing.assert_array_equal(got[defined], gold[defined])
    chw = t_sample_360(cli["tsat"], cli["tgrid"], tc, out_layout="chw").numpy()
    np.testing.assert_array_equal(chw, got.transpose(2, 0, 1))


@pytest.mark.parametrize("center", CENTERS)
def test_expand_sampled_rect_bit_equal_to_foveax(cli, center):
    w, h = cli["w"], cli["h"]
    c = jnp.asarray(center, jnp.float32)
    reduced = np.array(sample_rect_from_sat(cli["sat"], cli["grid"], c))
    fn = jax.jit(lambda r, c: fx_expand(r, w, h, c))
    want = np.asarray(fn(jnp.asarray(reduced), c))
    got = t_expand(torch.from_numpy(reduced), w, h,
                   torch.tensor(center, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, golden.expand_sampled_rect(reduced, w, h,
                                                                  center))


def test_point_grid_bit_equal_to_foveax(cli):
    args = (cli["wr"], cli["hr"], cli["w"], cli["h"])
    fg, tg = fx_make_point_grid(*args), t_make_point_grid(*args, "cpu")
    np.testing.assert_array_equal(tg.gx.numpy(), np.asarray(fg.gx))
    np.testing.assert_array_equal(tg.gy.numpy(), np.asarray(fg.gy))
    assert tg.gx.shape == (cli["wr"],) and tg.gy.shape == (cli["hr"],)


@pytest.mark.parametrize("center", CENTERS)
def test_sample_rect_point_bit_equal_to_foveax(cli, center):
    args = (cli["wr"], cli["hr"], cli["w"], cli["h"])
    fg, tg = fx_make_point_grid(*args), t_make_point_grid(*args, "cpu")
    c = jnp.asarray(center, jnp.float32)
    want = np.asarray(jax.jit(lambda f, c: fx_point(f, fg, c))(
        jnp.asarray(cli["frame"]), c))
    got = t_point(torch.from_numpy(cli["frame"]), tg,
                  torch.tensor(center, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(got, want)
    if center[0] < 1.0 and center[1] < 1.0:  # the golden scales in float64
        np.testing.assert_array_equal(
            got, golden.sample_rect_point(cli["frame"], cli["wr"], cli["hr"], center))
