"""foveax_torch's log-polar baseline (``core/logpolar.py``) on the CPU,
held against foveax on the same inputs made from numpy seeds: the grid,
the point sample, the pyramid and the pyramid sample bit-equal (integer
gathers and box means); the float32 blur and unwarp within 1 LSB of
foveax (jitted XLA contracts multiply-adds into FMAs, eager torch does
not) and within foveax's own tolerances of the float64 golden."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foveax.core import golden
from foveax.core import logpolar as fx
from foveax_torch.convert import logpolar_grid_from_numpy
from foveax_torch.core import logpolar as pt

torch.set_num_threads(1)

# (source w, h, log-polar out w, h)
SHAPES = [(96, 64, 32, 24), (256, 128, 144, 80)]
GAZES = [(0.5, 0.5), (0.25, 0.75), (0.3, 0.4), (0.0, 0.0), (0.97, 0.9)]
LEVELS = 3
# Share of unwarped pixels that differ from foveax's at all (each by
# exactly 1): measured worst 3.5e-4 over both shapes, three seeds and six
# gazes, all from the bilinear blend's multiply-adds.
UNWARP_SHARE_DIFFERENT = 2e-3


def _frame(w, h, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _grids(w, h, wo, ho):
    return fx.make_logpolar_grid(wo, ho, w, h), pt.make_logpolar_grid(
        wo, ho, w, h, device="cpu")


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def case(request):
    w, h, wo, ho = request.param
    fg, tg = _grids(w, h, wo, ho)
    return dict(w=w, h=h, wo=wo, ho=ho, frame=_frame(w, h, 5), fg=fg, tg=tg)


_sample = jax.jit(fx.sample_logpolar)
_blur = jax.jit(fx.logpolar_gaussian_blur)


def _c(gaze):
    return jnp.asarray(gaze, jnp.float32), torch.tensor(gaze, dtype=torch.float32)


def test_grid_bit_equal(case):
    np.testing.assert_array_equal(case["tg"].deltas.numpy(),
                                  np.asarray(case["fg"].deltas))
    carried = logpolar_grid_from_numpy(np.asarray(case["fg"].deltas), case["wo"],
                                       case["ho"], case["w"], case["h"],
                                       device="cpu")
    assert torch.equal(carried.deltas, case["tg"].deltas)
    with pytest.raises(ValueError):
        logpolar_grid_from_numpy(np.zeros((2, 2, 2), np.int16), 3, 3, 8, 8,
                                 device="cpu")


@pytest.mark.parametrize("gaze", GAZES)
def test_sample_bit_equal(case, gaze):
    cf, ct = _c(gaze)
    want = np.asarray(_sample(jnp.asarray(case["frame"]), case["fg"], cf))
    got = pt.sample_logpolar(torch.from_numpy(case["frame"]), case["tg"], ct).numpy()
    assert got.shape == (case["ho"], case["wo"], 3)
    np.testing.assert_array_equal(got, want)


def test_sample_matches_float64_golden():
    frame = _frame(96, 64, 6)
    _, tg = _grids(96, 64, 32, 24)
    for gaze in [(0.5, 0.5), (0.25, 0.75)]:
        out = pt.sample_logpolar(torch.from_numpy(frame), tg, torch.tensor(gaze)).numpy()
        ref = golden.sample_logpolar(frame, 32, 24, gaze)
        assert (out == ref).all(axis=-1).mean() > 0.97


@pytest.mark.parametrize("gaze", GAZES)
def test_blur_within_one_lsb(case, gaze):
    cf, _ = _c(gaze)
    lp = np.array(_sample(jnp.asarray(case["frame"]), case["fg"], cf))
    want = np.asarray(_blur(jnp.asarray(lp)))
    got = pt.logpolar_gaussian_blur(torch.from_numpy(lp)).numpy()
    assert got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, d.max()
    # The inner radial half is copied through untouched.
    half = case["wo"] // 2
    np.testing.assert_array_equal(got[:, :half], lp[:, :half])


def test_blur_matches_float64_golden():
    img = _frame(32, 24, 8)
    out = pt.logpolar_gaussian_blur(torch.from_numpy(img)).numpy()
    d = np.abs(out.astype(np.int32) - golden.logpolar_blur(img).astype(np.int32))
    assert d.max() <= 1, d.max()


@pytest.mark.parametrize("gaze", GAZES)
def test_unwarp_within_one_lsb(case, gaze):
    w, h = case["w"], case["h"]
    cf, ct = _c(gaze)
    lp = np.array(_sample(jnp.asarray(case["frame"]), case["fg"], cf))
    unwarp = jax.jit(lambda r, c: fx.unwarp_logpolar(r, w, h, c))
    want = np.asarray(unwarp(jnp.asarray(lp), cf))
    got = pt.unwarp_logpolar(torch.from_numpy(lp), w, h, ct).numpy()
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= UNWARP_SHARE_DIFFERENT, (d > 0).mean()


def test_unwarp_matches_float64_golden():
    """foveax's own tolerance (tests/test_logpolar.py): 97% of pixels
    within 1 LSB of the golden, median difference 0."""
    frame = _frame(96, 64, 9)
    _, tg = _grids(96, 64, 32, 24)
    c = torch.tensor([0.5, 0.5])
    red = pt.sample_logpolar(torch.from_numpy(frame), tg, c)
    out = pt.unwarp_logpolar(red, 96, 64, c).numpy()
    ref = golden.unwarp_logpolar(red.numpy(), 96, 64, (0.5, 0.5))
    d = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert (d <= 1).mean() > 0.97, (d.max(), (d > 1).mean())
    assert np.median(d) == 0


@pytest.mark.parametrize("levels", [1, 3, 4])
def test_pyramid_bit_equal(case, levels):
    frame = case["frame"]
    got = pt.build_pyramid(torch.from_numpy(frame), levels).numpy()
    np.testing.assert_array_equal(got, np.asarray(fx.build_pyramid(jnp.asarray(frame),
                                                                   levels)))
    np.testing.assert_array_equal(got, golden.build_pyramid_flat(frame, levels))
    assert pt.pyramid_layout(case["w"], case["h"], levels) == fx.pyramid_layout(
        case["w"], case["h"], levels)


@pytest.mark.parametrize("gaze", GAZES)
def test_pyramid_sample_bit_equal(case, gaze):
    cf, ct = _c(gaze)
    frame = case["frame"]
    fpyr = fx.build_pyramid(jnp.asarray(frame), LEVELS)
    sample = jax.jit(lambda p, c: fx.sample_logpolar_pyramid(p, case["fg"], c, LEVELS))
    want = np.asarray(sample(fpyr, cf))
    got = pt.sample_logpolar_pyramid(pt.build_pyramid(torch.from_numpy(frame), LEVELS),
                                     case["tg"], ct, LEVELS).numpy()
    np.testing.assert_array_equal(got, want)


def test_grid_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.make_logpolar_grid(32, 24, 96, 64)
