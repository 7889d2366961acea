"""Quality metrics for foveation evaluation (counterpart of
``foveax/core/metrics.py``).

The reference paper evaluates techniques by PSNR/quality vs the original
frame (results live in the paper, not the repo — SURVEY.md §6).  The
measurement tools: full-frame PSNR, sphere-weighted WS-PSNR, foveal-region
PSNR (quality where the user is actually looking), eccentricity-weighted
PSNR (a simple acuity falloff weighting), and SSIM with the same foveal
and eccentricity variants.  Every function takes (H, W, C) frames on one
device and returns a 0-dim float32 tensor there.

The SSIM window filter is written as shifted float32 multiply-adds, not as
a convolution: a cuDNN convolution may run in TF32 on the card, and the
E[x^2] - mu^2 cancellation of :func:`ssim_map` needs full float32.
Reductions run in another order on the card than on the CPU, so results
agree to a tolerance, not to the bit.
"""

from __future__ import annotations

import math

import torch


def _f32(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32)


def _psnr_of(m: torch.Tensor, peak: float = 255.0) -> torch.Tensor:
    return 10.0 * torch.log10(peak * peak / torch.clamp_min(m, 1e-10))


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = _f32(a) - _f32(b)
    return torch.mean(d * d)


def psnr(a: torch.Tensor, b: torch.Tensor, peak: float = 255.0) -> torch.Tensor:
    return _psnr_of(mse(a, b), peak)


def _gaze_distance2(h, w, center, device, offset=0.0, full=None):
    """Squared distance of each pixel to the gaze, (h, w) float32, x
    wrapped across the 360 seam; ``full`` = the frame's (H, W) when the
    grid is a window of it offset by ``offset`` on both axes."""
    fh, fw = full or (h, w)
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None] + offset
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :] + offset
    c = _f32(center)
    dx = torch.abs(xs - c[0] * fw)
    dx = torch.minimum(dx, fw - dx)  # 360 wrap
    dy = ys - c[1] * fh
    return dx * dx + dy * dy


def foveal_psnr(
    a: torch.Tensor, b: torch.Tensor, center: torch.Tensor, radius_frac: float = 0.1
) -> torch.Tensor:
    """PSNR restricted to a disc of ``radius_frac * height`` around the
    gaze (x distance wraps across the 360 seam)."""
    h, w = a.shape[:2]
    r = radius_frac * h
    mask = (_gaze_distance2(h, w, center, a.device) <= r * r).to(torch.float32)
    d = _f32(a) - _f32(b)
    m = torch.sum(d * d * mask[..., None]) / torch.clamp_min(
        torch.sum(mask) * a.shape[-1], 1
    )
    return _psnr_of(m)


def ws_psnr(a: torch.Tensor, b: torch.Tensor, peak: float = 255.0) -> torch.Tensor:
    """WS-PSNR: sphere-weighted PSNR for equirectangular frames.

    Each row is weighted by cos(latitude) at the pixel center,
    w(y) = cos((y + 0.5 - H/2) * pi / H) (Sun, Lu, Yu — IEEE SPL 2017;
    adopted by JVET for 360 video).  Uniform error gives planar PSNR;
    pole-concentrated error is down-weighted toward its solid-angle share.
    """
    h = a.shape[0]
    ys = (torch.arange(h, dtype=torch.float32, device=a.device) + 0.5 - h / 2.0) * (
        math.pi / h
    )
    wgt = torch.cos(ys)[:, None, None]  # (H, 1, 1) broadcasts over W, C
    d = _f32(a) - _f32(b)
    m = torch.sum(d * d * wgt) / (torch.sum(wgt) * a.shape[1] * a.shape[2])
    return _psnr_of(m, peak)


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    xs = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return g / torch.sum(g)


def _filter2_valid(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable 2-D window filter, VALID padding, channels vectorized:
    (H, W, C) float32 -> (H-k+1, W-k+1, C), as k shifted float32
    multiply-adds per axis in tap order (no convolution, no TF32)."""
    k = win.shape[0]
    h, w = img.shape[0] - k + 1, img.shape[1] - k + 1
    rows = win[0] * img[0:h]
    for t in range(1, k):
        rows = rows + win[t] * img[t : t + h]
    out = win[0] * rows[:, 0:w]
    for t in range(1, k):
        out = out + win[t] * rows[:, t : t + w]
    return out


def ssim_map(
    a: torch.Tensor,
    b: torch.Tensor,
    peak: float = 255.0,
    win_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Per-pixel SSIM index map (Wang et al., IEEE TIP 2004).

    Standard constants K1=0.01, K2=0.03, 11x11 Gaussian window with
    sigma 1.5 (scikit-image's ``gaussian_weights=True`` window) and the
    population variance form (``use_sample_covariance=False``).  Returns
    the (H-10, W-10, C) VALID-region map so weighted variants
    (foveal/eccentricity) can re-weight it spatially.
    """
    a = _f32(a)
    b = _f32(b)
    win = _gaussian_window(win_size, sigma, a.device)
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mu_a = _filter2_valid(a, win)
    mu_b = _filter2_valid(b, win)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    var_a = _filter2_valid(a * a, win) - mu_aa
    var_b = _filter2_valid(b * b, win) - mu_bb
    cov = _filter2_valid(a * b, win) - mu_ab
    return ((2.0 * mu_ab + c1) * (2.0 * cov + c2)) / (
        (mu_aa + mu_bb + c1) * (var_a + var_b + c2)
    )


def ssim(a: torch.Tensor, b: torch.Tensor, peak: float = 255.0) -> torch.Tensor:
    """Mean structural similarity over the frame (1.0 = identical)."""
    return torch.mean(ssim_map(a, b, peak))


def _valid_center_weights(shape, center, radius_frac, kind, device):
    """Gaze weight map on the SSIM map's VALID region (offset k//2)."""
    h, w = shape[0] + 10, shape[1] + 10  # original frame dims (k=11)
    d2 = _gaze_distance2(shape[0], shape[1], center, device, 5.0, (h, w))
    r = radius_frac * h
    if kind == "disc":
        return (d2 <= r * r).to(torch.float32)
    return torch.exp(-d2 / (2.0 * r * r))


def foveal_ssim(
    a: torch.Tensor, b: torch.Tensor, center: torch.Tensor, radius_frac: float = 0.1
) -> torch.Tensor:
    """Mean SSIM restricted to a disc of ``radius_frac * height`` around
    the gaze (x wraps across the 360 seam) — the SSIM twin of
    :func:`foveal_psnr`."""
    m = ssim_map(a, b)
    wgt = _valid_center_weights(m.shape, center, radius_frac, "disc", a.device)
    return torch.sum(m * wgt[..., None]) / torch.clamp_min(
        torch.sum(wgt) * a.shape[-1], 1.0
    )


def eccentricity_weighted_ssim(
    a: torch.Tensor, b: torch.Tensor, center: torch.Tensor, sigma_frac: float = 0.25
) -> torch.Tensor:
    """SSIM with the same Gaussian acuity falloff as
    :func:`eccentricity_weighted_psnr`."""
    m = ssim_map(a, b)
    wgt = _valid_center_weights(m.shape, center, sigma_frac, "gauss", a.device)
    return torch.sum(m * wgt[..., None]) / torch.clamp_min(
        torch.sum(wgt) * a.shape[-1], 1e-6
    )


def eccentricity_weighted_psnr(
    a: torch.Tensor, b: torch.Tensor, center: torch.Tensor, sigma_frac: float = 0.25
) -> torch.Tensor:
    """PSNR with a Gaussian acuity falloff around the gaze — errors in the
    periphery matter less, mirroring what foveated rendering exploits."""
    h, w = a.shape[:2]
    sig = sigma_frac * h
    wgt = torch.exp(-_gaze_distance2(h, w, center, a.device) / (2.0 * sig * sig))
    d = _f32(a) - _f32(b)
    m = torch.sum(d * d * wgt[..., None]) / torch.clamp_min(
        torch.sum(wgt) * a.shape[-1], 1e-6
    )
    return _psnr_of(m)
