"""foveax_torch's SAT build, decode and row select (plain versions of
kernels K5/K6 on the CPU) against foveax: bit-identical to
``core.sat.build_sat``/``decode_sat``, to ``build_sat_pallas`` and
``sat_select_rows`` in interpret mode, and to foveax's mod-2^32 wrap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foveax.core.sat import build_sat as fx_build_sat
from foveax.core.sat import decode_sat as fx_decode_sat
from foveax.kernels.fused_select import sat_select_rows as fx_select_rows
from foveax.kernels.scan2d import build_sat_pallas
from foveax_torch.core.sat import build_sat, decode_sat
from foveax_torch.kernels import scan2d
from foveax_torch.kernels.fused_select import sat_select_rows

torch.set_num_threads(1)

OFFSET = 0xFEDCBA98


def _frame(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("layout", ["hwc", "chw"])
@pytest.mark.parametrize("h, w", [(33, 47), (64, 256), (40, 128)])
def test_build_sat_matches_foveax(h, w, layout):
    frame = _frame((h, w, 3), h * w)
    want = np.asarray(jax.jit(fx_build_sat)(jnp.asarray(frame)))
    src = frame if layout == "hwc" else np.ascontiguousarray(frame.transpose(2, 0, 1))
    got = build_sat(torch.from_numpy(src), in_layout=layout)
    assert got.dtype == torch.uint32 and got.shape == (3, h, w)
    np.testing.assert_array_equal(got.numpy(), want)
    if w % 128 == 0:
        pallas = build_sat_pallas(
            jnp.asarray(src), block_rows=8, interpret=True, in_layout=layout
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize(
    "shape, layout, match",
    [((4, 4, 3), "hw3", "in_layout"), ((4, 4), "hwc", "3 channels"),
     ((4, 4, 3), "chw", "3 channels")],
)
def test_build_sat_rejects_bad_input(shape, layout, match):
    with pytest.raises(ValueError, match=match):
        build_sat(torch.zeros(shape, dtype=torch.uint8), in_layout=layout)


def test_low32_keeps_the_bits_past_2_31_and_2_32():
    """The plain SAT's int64 -> uint32 step wraps mod 2^32, and back."""
    vals = np.asarray(
        [0, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 8_460_288_000, 3 * 2**32 + 7],
        np.int64,
    )
    got = scan2d.low32(torch.from_numpy(vals))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), (vals % 2**32).astype(np.uint32))
    np.testing.assert_array_equal(scan2d.as_int64(got).numpy(), vals % 2**32)


def test_decode_roundtrips_and_matches_foveax():
    frame = _frame((33, 47, 3), 7)
    sat = build_sat(torch.from_numpy(frame))
    got = decode_sat(sat)
    assert got.dtype == torch.uint8 and got.shape == frame.shape
    np.testing.assert_array_equal(got.numpy(), frame)
    want = jax.jit(fx_decode_sat)(jnp.asarray(sat.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrap_semantics_match_foveax():
    """A SAT offset by a huge constant mod 2^32 (as tests/test_sat.py
    does) decodes as foveax decodes it, and its 4-tap differences are
    unchanged."""
    frame = _frame((33, 47, 3), 7)
    sat = build_sat(torch.from_numpy(frame))
    shifted_np = (sat.numpy().astype(np.uint64) + OFFSET) % 2**32
    shifted_np = shifted_np.astype(np.uint32)
    shifted = torch.from_numpy(shifted_np)
    got = decode_sat(shifted).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.jit(fx_decode_sat)(jnp.asarray(shifted_np)))
    )
    np.testing.assert_array_equal(got[1:, 1:], frame[1:, 1:])


def _select_cases():
    rng = np.random.default_rng(11)
    h, w, n = 64, 256, 20
    pyc = np.sort(rng.integers(1, h, n)).astype(np.int32)
    pymc = np.minimum(np.sort(rng.integers(0, h - 1, n)), pyc - 1).astype(np.int32)
    yield "sorted", _frame((h, w, 3), 12), pyc, pymc
    # Duplicates (fovea), block boundaries and the extremes, as
    # tests/test_kernels.py has them.
    yield (
        "duplicates",
        _frame((32, 128, 3), 13),
        np.asarray([1, 7, 8, 8, 8, 9, 16, 31, 31], np.int32),
        np.asarray([0, 6, 7, 7, 7, 8, 15, 30, 30], np.int32),
    )


@pytest.mark.parametrize(
    "case", list(_select_cases()), ids=lambda c: c[0] if isinstance(c, tuple) else c
)
def test_select_rows_matches_foveax(case):
    _, frame, pyc, pymc = case
    rcw = np.ascontiguousarray(frame.transpose(0, 2, 1))
    want_hi, want_lo = fx_select_rows(
        jnp.asarray(rcw), jnp.asarray(pyc), jnp.asarray(pymc), block_rows=8,
        interpret=True,
    )
    got_hi, got_lo = sat_select_rows(
        torch.from_numpy(rcw), torch.from_numpy(pyc), torch.from_numpy(pymc)
    )
    n, w = len(pyc), frame.shape[1]
    for got, want in ((got_hi, want_hi), (got_lo, want_lo)):
        assert got.dtype == torch.uint32 and got.shape == (n, 3, w)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, :3])


def test_select_rows_plain_needs_no_order():
    """The plain version selects rows in any order (only the kernel walks
    the lists with cursors)."""
    frame = _frame((24, 40, 3), 14)
    rcw = torch.from_numpy(np.ascontiguousarray(frame.transpose(0, 2, 1)))
    sat = build_sat(torch.from_numpy(frame)).numpy()
    pyc = np.asarray([23, 0, 5, 5, 17], np.int32)
    hi, lo = sat_select_rows(rcw, torch.from_numpy(pyc), torch.from_numpy(pyc[::-1].copy()))
    np.testing.assert_array_equal(hi.numpy(), sat[:, pyc].transpose(1, 0, 2))
    np.testing.assert_array_equal(lo.numpy(), sat[:, pyc[::-1]].transpose(1, 0, 2))


@pytest.mark.parametrize("column_stride", [1, 3], ids=["chw", "hwc"])
@pytest.mark.parametrize("h, w", [(1080, 1920), (2160, 3840), (4320, 7680),
                                  (8640, 15360)], ids=["1080p", "4k", "8k", "16k"])
def test_sat_plan_fits_the_card(h, w, column_stride):
    """The host-side launch plan of K5/K6: a scanning block spans the row
    within 512 threads, its dynamic shared memory fits the card's 227 KB,
    and the band-total scratch holds every band but the last."""
    plan = scan2d.sat_plan(h, w, column_stride=column_stride)
    assert plan.shared_bytes <= scan2d.MAX_SHARED_BYTES
    assert plan.threads % 32 == 0 and plan.threads <= scan2d.MAX_THREADS
    assert plan.threads * plan.chunks_per_thread * scan2d.CHUNK >= w
    assert (plan.threads - 32) * plan.chunks_per_thread * scan2d.CHUNK < w
    assert plan.step_rows >= 1 and plan.launches == 3
    bands = -(-h // plan.band_rows)
    assert plan.scratch_words == 3 * (bands - 1) * -(-w // 16) * 16


def test_sat_plan_one_band_launches_once():
    plan = scan2d.sat_plan(scan2d.BAND_ROWS, 17)
    assert (plan.launches, plan.scratch_words, plan.threads) == (1, 0, 32)


@pytest.mark.parametrize("column_stride", [1, 3], ids=["chw", "hwc"])
@pytest.mark.parametrize("w", [32784, 36000, 65536, 70000, 100000, 131072])
def test_sat_plan_tiles_wide_frames(w, column_stride):
    """Past the 32,768 columns one scanning block spans, the plan cuts the
    row into column tiles, walked as ``csrc/scan2d.cu`` walks them (from 0
    in steps of MAX_WIDTH, the last one ragged unless W is a multiple):
    they cover [0, W) once, each starting on a 16-column boundary, a block
    of the plan spans a whole tile within the card's shared memory, and
    the band-total scratch holds the whole width."""
    h = 18000
    plan = scan2d.sat_plan(h, w, column_stride=column_stride)
    tiles = [(x0, min(scan2d.MAX_WIDTH, w - x0))
             for x0 in range(0, w, scan2d.MAX_WIDTH)]
    assert len(tiles) == plan.tiles == -(-w // scan2d.MAX_WIDTH) >= 2
    assert tiles[-1][1] == (w % scan2d.MAX_WIDTH or scan2d.MAX_WIDTH)
    covered = np.zeros(w, np.int64)
    for x0, tw in tiles:
        assert x0 % scan2d.CHUNK == 0 and 1 <= tw <= scan2d.MAX_WIDTH
        covered[x0:x0 + tw] += 1
    assert (covered == 1).all()
    assert (plan.threads, plan.chunks_per_thread) == (scan2d.MAX_THREADS, 4)
    assert plan.threads * plan.chunks_per_thread * scan2d.CHUNK == scan2d.MAX_WIDTH
    assert plan.shared_bytes <= scan2d.MAX_SHARED_BYTES
    bands = -(-h // plan.band_rows)
    assert plan.scratch_words == 3 * (bands - 1) * -(-w // 16) * 16
    assert plan.launches == 2 + plan.tiles


@pytest.mark.parametrize("h, w", [(0, 64), (64, 0)])
def test_sat_plan_refuses_empty_frame(h, w):
    """An empty frame has no plan (the wrappers launch nothing for it)."""
    with pytest.raises(ValueError, match=f"empty {w}x{h} frame"):
        scan2d.sat_plan(h, w)
