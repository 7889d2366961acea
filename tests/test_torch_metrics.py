"""foveax_torch's quality metrics (``core/metrics.py``) on the CPU, held
against foveax on the same inputs made from numpy seeds.  Reductions and
the SSIM window filter sum in another order than XLA's (and the port
filters with shifted multiply-adds where foveax convolves), so each
metric agrees to a stated tolerance: PSNRs within 1e-4 dB, SSIMs within
1e-5, MSE within 1e-6 of its value (measured worst: 5.7e-6 dB, 1.3e-6 and
1.2e-7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foveax.core import golden
from foveax.core import metrics as fx
from foveax_torch.core import metrics as pt

torch.set_num_threads(1)

PSNR_DB = 1e-4
SSIM_ABS = 1e-5
MSE_REL = 1e-6
SSIM_MAP_ABS = 1e-5  # per-pixel map; measured worst 3.7e-6
GAZES = [(0.5, 0.5), (0.3, 0.4), (0.0, 0.0), (0.97, 0.9)]
PAIR_METRICS = ["mse", "psnr", "ws_psnr", "ssim"]
GAZE_METRICS = ["foveal_psnr", "eccentricity_weighted_psnr", "foveal_ssim",
                "eccentricity_weighted_ssim"]


def _pair(w, h, seed, noise=20):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, 3), np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-noise, noise, a.shape), 0, 255)
    return a, b.astype(np.uint8)


def _tolerance(name, want):
    if name == "mse":
        return MSE_REL * abs(want)
    return SSIM_ABS if "ssim" in name else PSNR_DB


def _check(name, got, want):
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= _tolerance(name, want), (name, float(got), want)


@pytest.mark.parametrize("shape", [(96, 64), (256, 128)], ids=["96x64", "256x128"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", PAIR_METRICS)
def test_pair_metrics_match_foveax(shape, seed, name):
    a, b = _pair(*shape, seed)
    want = float(jax.jit(getattr(fx, name))(jnp.asarray(a), jnp.asarray(b)))
    _check(name, getattr(pt, name)(torch.from_numpy(a), torch.from_numpy(b)), want)


@pytest.mark.parametrize("gaze", GAZES)
@pytest.mark.parametrize("name", GAZE_METRICS)
def test_gaze_metrics_match_foveax(gaze, name):
    a, b = _pair(256, 128, 3)
    fn = jax.jit(getattr(fx, name))
    want = float(fn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(gaze, jnp.float32)))
    got = getattr(pt, name)(torch.from_numpy(a), torch.from_numpy(b),
                            torch.tensor(gaze, dtype=torch.float32))
    _check(name, got, want)


def test_ssim_map_matches_foveax():
    a, b = _pair(96, 64, 4)
    want = np.asarray(jax.jit(fx.ssim_map)(jnp.asarray(a), jnp.asarray(b)))
    got = pt.ssim_map(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (54, 86, 3)
    assert np.abs(got - want).max() <= SSIM_MAP_ABS


def test_ssim_matches_float64_golden():
    a, b = _pair(64, 48, 5, noise=40)
    got = float(pt.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - golden.ssim64(a, b)) < 1e-4


def test_identity_and_known_values():
    a, _ = _pair(96, 64, 6)
    ta = torch.from_numpy(a)
    assert float(pt.psnr(ta, ta)) > 90.0
    assert abs(float(pt.ssim(ta, ta)) - 1.0) < 1e-6
    b = np.clip(a.astype(np.int32) + 10, 0, 255).astype(np.uint8)
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    assert abs(float(pt.psnr(ta, torch.from_numpy(b)))
               - 10 * np.log10(255.0**2 / mse)) < 1e-3


def test_ws_psnr_uniform_error_equals_planar():
    a = np.full((64, 96, 3), 100, np.uint8)
    b = np.full((64, 96, 3), 110, np.uint8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert abs(float(pt.ws_psnr(ta, tb)) - float(pt.psnr(ta, tb))) < 1e-3


def test_foveal_psnr_ignores_periphery():
    a, _ = _pair(96, 64, 7)
    b = a.copy()
    b[:, :10] = 0  # damage far from the gaze at (0.5, 0.5)
    c = torch.tensor([0.5, 0.5])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert float(pt.foveal_psnr(ta, tb, c)) > 90.0
    assert float(pt.psnr(ta, tb)) < 40.0
