"""Inverse gnomonic (rectilinear-viewport) projection from equirectangular
(counterpart of ``foveax/core/gnomonic.py``).

For each viewport pixel, project through the tangent plane at the gaze
center onto the sphere and fetch the nearest equirect texel (reference:
src/projections_program.cl:1-47, host src/projections.cc:51-86).  The
reference's viewport FOV scale is (6, 3) (src/projections_program.cl:20).

The reference divides by rho without guarding the viewport center
(rho == 0 -> NaN); the center pixel maps to the gaze point here, the
analytic limit, as in the JAX package.  The math is float32; ``atan``,
``asin``, ``atan2``, ``sin`` and ``cos`` are not correctly rounded on the
card or on the CPU, so a few source indices may move by one at cell
borders between devices.
"""

from __future__ import annotations

import numpy as np
import torch


def gnomonic_project(
    frame: torch.Tensor,
    out_width: int,
    out_height: int,
    center: torch.Tensor,
    scale: tuple[float, float] = (6.0, 3.0),
) -> torch.Tensor:
    """(Hs, Ws, 3) uint8 equirect -> (out_h, out_w, 3) uint8 viewport."""
    hs, ws, _ = frame.shape
    dev = frame.device
    f32 = torch.float32

    u = (torch.arange(out_width, dtype=f32, device=dev) / out_width - 0.5) * scale[0]
    v = (torch.arange(out_height, dtype=f32, device=dev) / out_height - 0.5) * scale[1]
    x = u[None, :].expand(out_height, out_width)
    y = v[:, None].expand(out_height, out_width)

    c = center.to(f32)
    phi1 = (c[1] - 0.5) * float(np.float32(np.pi))
    lam0 = (c[0] - 0.5) * float(np.float32(2.0 * np.pi))

    rho = torch.sqrt(x * x + y * y)
    safe_rho = torch.where(rho == 0, 1.0, rho)
    cc = torch.atan(rho)
    cos_c, sin_c = torch.cos(cc), torch.sin(cc)
    sin_phi1, cos_phi1 = torch.sin(phi1), torch.cos(phi1)
    phi = torch.asin(
        torch.clamp(
            cos_c * sin_phi1 + (y * sin_c * cos_phi1) / safe_rho, -1.0, 1.0
        )
    )
    lam = lam0 + torch.atan2(
        x * sin_c, rho * cos_phi1 * cos_c - y * sin_phi1 * sin_c
    )
    # Center pixel: analytic limit (the reference NaNs here).
    phi = torch.where(rho == 0, phi1, phi)
    lam = torch.where(rho == 0, lam0, lam)

    two_pi = float(np.float32(2.0 * np.pi))
    half_pi = float(np.float32(np.pi / 2))
    ten_pi = float(10 * np.float32(np.pi))
    phi = torch.remainder(phi + half_pi + ten_pi, two_pi)
    lam = torch.remainder(lam + float(np.float32(np.pi)) + ten_pi, two_pi)

    su = torch.clamp(lam / two_pi, 0.0, 0.999)
    sv = torch.clamp(phi / float(np.float32(np.pi)), 0.0, 0.999)

    sx = (su * ws).to(torch.int32)
    sy = (sv * hs).to(torch.int32)
    return frame.reshape(-1, 3)[(sy * ws + sx).long()]
