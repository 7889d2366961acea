"""foveax_torch's unwarp (plain versions of kernels K3/K4 on the CPU)
against foveax: the fused unwarp bit-identical to ``unwarp_rect_fused`` in
interpret mode and default xy order, the exact unwarp bit-identical to
``unwarp_rect(precision="exact")``, and the per-axis vectors equal over
every integer gaze.

The JAX references are jitted with the gaze traced, so each shape compiles
once per module.  CPU ``precision="auto"`` in foveax resolves to "fast",
so the fused function is called by name."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foveax.core.unwarp import _axis_vectors as fx_axis_vectors
from foveax.core.unwarp import unwarp_rect as fx_unwarp_rect
from foveax.kernels.unwarp_pl import unwarp_rect_fused as fx_unwarp_fused
from foveax_torch.core.unwarp import _axis_vectors, unwarp_rect
from foveax_torch.kernels import unwarp as unwarp_k
from foveax_torch.kernels.unwarp import unwarp_rect_fused

torch.set_num_threads(1)

# (source width, source height, reduced width, reduced height)
SHAPES = {"1920x512": (1920, 512, 1072, 288), "1080p": (1920, 1080, 1072, 608)}
CENTERS = [(0.5, 0.5), (0.03, 0.4), (0.0, 0.0), (1.0, 1.0), (0.999, 0.001)]


@pytest.fixture(autouse=True)
def _default_unwarp_knobs(monkeypatch):
    """Hold the port against foveax's defaults (xy order, int8 dots, the
    default x geometry)."""
    for knob in ("FOVEAX_UNWARP_ORDER", "FOVEAX_UNWARP_INT8", "FOVEAX_UNWARP_GEOM"):
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def refs():
    """Per shape: a random reduced frame (hwc) and the jitted references."""
    rng = np.random.default_rng(7)
    out = {}
    for name, (w, h, wr, hr) in SHAPES.items():
        out[name] = dict(
            reduced=rng.integers(0, 256, (hr, wr, 3), np.uint8),
            fused=jax.jit(
                lambda r, c, w=w, h=h: fx_unwarp_fused(
                    r, w, h, c, interpret=True
                )
            ),
            exact=jax.jit(lambda r, c, w=w, h=h: fx_unwarp_rect(r, w, h, c)),
        )
    return out


def _run(refs, name, center, which):
    w, h, _, _ = SHAPES[name]
    red = refs[name]["reduced"]
    ref = np.asarray(
        refs[name][which](jnp.asarray(red), jnp.asarray(center, jnp.float32))
    )
    fn = unwarp_rect_fused if which == "fused" else unwarp_rect
    got = fn(torch.from_numpy(red), w, h, torch.tensor(center)).numpy()
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    return got, ref, red


def _fovea(img, center, w, h, k=6):
    cx = int(np.float32(center[0]) * np.float32(w))
    cy = int(np.float32(center[1]) * np.float32(h))
    return img[max(cy - k, 0) : cy + k + 1, max(cx - k, 0) : cx + k + 1]


@pytest.mark.parametrize("center", CENTERS)
def test_fused_matches_jax_1920x512(refs, center):
    got, ref, _ = _run(refs, "1920x512", center, "fused")
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("center", [(0.37, 0.62), (0.999, 0.001)])
def test_fused_matches_jax_1080p_fovea_exact(refs, center):
    got, ref, red = _run(refs, "1080p", center, "fused")
    np.testing.assert_array_equal(got, ref)
    if center == (0.37, 0.62):
        # Away from the edges the fovea passes the reduced texels through.
        np.testing.assert_array_equal(
            _fovea(got, center, 1920, 1080),
            _fovea(red, (0.5, 0.5), 1072, 608),
        )


@pytest.mark.parametrize("name", SHAPES)
@pytest.mark.parametrize("center", [(0.5, 0.5), (0.03, 0.4), (1.0, 1.0)])
def test_exact_matches_jax(refs, name, center):
    """Bit for bit: XLA-CPU contracts the exact blend into FMAs, and the
    port's plain float32 blend rounds each step once the same way."""
    got, ref, _ = _run(refs, name, center, "exact")
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("center", [(0.31, 0.87), (0.999, 0.001)])
def test_fused_within_one_lsb_of_exact(refs, center):
    """foveax's own contract for the fused unwarp, held by the port."""
    w, h, _, _ = SHAPES["1080p"]
    red = torch.from_numpy(refs["1080p"]["reduced"])
    c = torch.tensor(center)
    fused = unwarp_rect_fused(red, w, h, c).numpy().astype(np.int32)
    exact = unwarp_rect(red, w, h, c).numpy().astype(np.int32)
    assert np.abs(fused - exact).max() <= 1
    np.testing.assert_array_equal(
        _fovea(fused, center, w, h), _fovea(exact, center, w, h)
    )


def test_layouts_and_precisions(refs):
    w, h, _, _ = SHAPES["1920x512"]
    red = torch.from_numpy(refs["1920x512"]["reduced"])
    c = torch.tensor((0.4, 0.7))
    hwc = unwarp_rect_fused(red, w, h, c)
    chw = unwarp_rect_fused(
        red.permute(2, 0, 1), w, h, c, in_layout="chw", out_layout="chw"
    )
    np.testing.assert_array_equal(hwc.numpy(), chw.numpy().transpose(1, 2, 0))
    for precision in ("fused", "auto"):
        np.testing.assert_array_equal(
            unwarp_rect(red, w, h, c, precision=precision).numpy(), hwc.numpy()
        )
    with pytest.raises(ValueError, match="precision"):
        unwarp_rect(red, w, h, c, precision="mm")


@pytest.mark.parametrize(
    "axis", ["x-1080p", "y-1080p", "x-1920x512", "y-1920x512"]
)
def test_axis_vectors_all_integer_gazes(axis):
    """(idx_lo, idx_hi, ratio, num, den, maxstep) for every integer
    scaled centre of the axis."""
    which, name = axis.split("-")
    w, h, wr, hr = SHAPES[name]
    out_dim, red, wrap = (w, wr, True) if which == "x" else (h, hr, False)
    cs = np.arange(out_dim + 1, dtype=np.int32)
    ref = jax.jit(
        jax.vmap(lambda c: fx_axis_vectors(out_dim, red, c, wrap=wrap)[:5])
    )(jnp.asarray(cs))
    got = _axis_vectors(out_dim, red, torch.from_numpy(cs)[:, None], wrap=wrap)
    for r, t in zip(ref, got[:5]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    assert got[5] == fx_axis_vectors(out_dim, red, jnp.int32(0), wrap=wrap)[5]


def _blend_numpy(a, b, num, den, bias):
    numi = (den - num) * a.astype(np.int32) + num * b.astype(np.int32)
    q = numi.astype(np.float32) * (np.float32(1) / den.astype(np.float32))
    return (q + np.float32(bias)).astype(np.int32).astype(np.uint8)


def test_passes_plain_blend():
    """K3/K4's plain versions against the numpy float32 steps."""
    rng = np.random.default_rng(4)
    src = rng.integers(0, 256, (3, 6, 10), np.uint8)
    lo = rng.integers(0, 9, 13).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 2, 13), 9).astype(np.int32)
    den = rng.integers(1, 30, 13).astype(np.int32)
    num = (rng.random(13) * (den + 1)).astype(np.int32).clip(0, den)
    t = torch.from_numpy
    xb = unwarp_k.unwarp_x_pass(t(src), t(lo), t(hi), t(num), t(den)).numpy()
    np.testing.assert_array_equal(
        xb, _blend_numpy(src[:, :, lo], src[:, :, hi], num, den, 0.5 + 2**-10)
    )
    lo_y, hi_y = np.clip(lo, 0, 5), np.clip(hi, 0, 5)
    out = unwarp_k.unwarp_y_pass(
        t(xb), t(lo_y), t(hi_y), t(num), t(den)
    ).numpy()
    np.testing.assert_array_equal(
        out,
        _blend_numpy(
            xb[:, lo_y], xb[:, hi_y], num[:, None], den[:, None], 0.01
        ),
    )
