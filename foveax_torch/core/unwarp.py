"""Inverse log-rectilinear unwarp (counterpart of ``foveax/core/unwarp.py``).

For every full-resolution output pixel: invert the log map to find the
enclosing reduced-frame texel, then bilinearly blend the two enclosing log
cells per axis with edge clamping (reference:
src/sat_decoder_interpolate_kernel.cl:1-151).  The inverse map is
separable, so every quantity is a 1-D vector per axis, driven by the gaze
as a runtime tensor.

Precisions:
  "exact" — four uint8 gathers and a float32 blend, in plain PyTorch (the
      JAX package computes it in XLA outside its kernels).
  "fused" — the integer-weight unwarp of ``foveax_torch/kernels/unwarp.py``
      (one kernel on the card): a column pass with round-half-up and a row
      pass with truncation, bit-identical to the JAX package's fused unwarp
      in its default xy order.  Its contract: both axes' delta steps
      <= 255; elsewhere it raises, as the JAX package's explicit request
      does.
  "auto"  — "fused" where its contract holds, "exact" elsewhere (the JAX
      package degrades an ineligible shape the same way).  Both are
      within 1 LSB of "exact", the JAX package's contract for "auto".
  "mm", "fast" — the JAX package's gather-free and pair-gather
      formulations for the TPU, with the same <= 1 LSB contract; here
      they resolve as "auto" does.

The inverse map's exponent ``ceil(0.5*rd*log(|d|/lam + 1)^0.25)`` depends
only on the integer ``|d|``, not on the gaze.  It is tabulated once per
shape on the CPU in float32, with the JAX package's expression and
evaluation order, so that no device ``log``/``pow`` (a third
implementation, with its own ulp errors at knife-edge ceilings) enters the
map: the CPU and CUDA paths agree by construction, and the tests hold the
table to XLA-CPU's entry by entry.  The table covers the ``|d|`` an axis
can reach: [0, out_dim] without wrap, [0, out_dim // 2] on the 360 wrap
axis.  (Past out_dim // 2 the x tables of 8K and 16K hold one entry each
where torch's and XLA's float32 ``log`` round to opposite sides of an
integer; the wrap axis never reads them.)
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from foveax_torch.core.logrect import delta_table, scaled_center
from foveax_torch.core.logrect import lam as _lam
from foveax_torch.pipeline import profiling

PRECISIONS = ("exact", "fused", "auto", "mm", "fast")


def u_raw_table(out_dim: int, reduced_dim: int, *, wrap: bool) -> torch.Tensor:
    """``ceil(0.5*rd * log(|d|/lam + 1) ** 0.25)`` for every integer
    ``|d|`` the axis reaches ([0, out_dim], or [0, out_dim // 2] with
    ``wrap``), computed in float32 on the CPU; int32."""
    n = out_dim // 2 if wrap else out_dim
    ad = torch.arange(n + 1, dtype=torch.float32)
    lam_out = torch.tensor(_lam(out_dim), dtype=torch.float32)
    half_rd = torch.tensor(0.5 * np.float32(reduced_dim), dtype=torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    return torch.ceil(half_rd * torch.log(ad / lam_out + one) ** 0.25).to(
        torch.int32
    )


@functools.lru_cache(maxsize=64)
def _axis_tables(out_dim: int, reduced_dim: int, wrap: bool,
                 device: torch.device):
    """Per-shape device tables: the inverse-map exponent
    (:func:`u_raw_table`), the forward-delta LUT and its offset, and the
    LUT's largest step."""
    u_off = reduced_dim // 2 + 2
    # The unwarp's forward deltas use lambda derived from the *output* dim
    # (reference: src/sat_decoder_interpolate_kernel.cl:11-12).
    lut_np = delta_table(-u_off, u_off, reduced_dim, out_dim)
    maxstep = int(np.abs(np.diff(lut_np.astype(np.int64))).max())
    return (
        u_raw_table(out_dim, reduced_dim, wrap=wrap).to(device),
        torch.from_numpy(lut_np).to(device),
        u_off,
        maxstep,
    )


def _axis_vectors(
    out_dim: int,
    reduced_dim: int,
    center_scaled: torch.Tensor,
    *,
    wrap: bool,
):
    """Per-axis 1-D quantities for the unwarp.

    ``center_scaled`` is the int32 ``trunc(center * out_dim)``: a scalar,
    or (B, 1) for B gazes at once.  Returns (idx_lo, idx_hi, ratio, num,
    den, maxstep): clamped reduced-frame indices of the two enclosing log
    cells (shape (out_dim,)), the blend factor, its exact integer
    numerator/denominator (den >= 1), and the LUT step bound.
    """
    dev = center_scaled.device
    u_tab, lut, u_off, maxstep = _axis_tables(out_dim, reduced_dim, wrap, dev)
    cp = center_scaled.to(torch.int32)
    p = torch.arange(out_dim, dtype=torch.int32, device=dev)

    # 360-degree wrap relative to the gaze (reference kernel :27-33).
    half = out_dim // 2
    if wrap:
        shift = torch.where(
            p - cp > half, -out_dim, torch.where(p - cp < -half, out_dim, 0)
        ).to(torch.int32)
    else:
        shift = torch.zeros_like(p - cp)
    offset = shift != 0
    pw = p + shift
    d = pw - cp  # delta from center, possibly wrapped

    # Inverse log map (reference kernel :43-48), exponent from the table.
    sd = torch.sign(d)
    u_raw = u_tab[d.abs().long()] * sd
    u = torch.where((u_raw.abs() > d.abs()) | (u_raw == 0), d, u_raw)

    d_calc = lut[(u + u_off).long()]

    # Neighbour cell toward the center; sign taken from u, not u+du
    # (reference kernel :75-89).
    du = -sd
    d_min = lut[(u + du + u_off).long()].abs() * torch.sign(u)

    lo = cp + torch.minimum(d_min, d_calc)
    hi = cp + torch.maximum(d_min, d_calc)
    u_lo = torch.minimum(u, u + du)
    u_hi = torch.maximum(u, u + du)

    # Edge clamping: collapse to the inner cell at frame borders; on the
    # wrap axis a wrapped pixel skips the collapse (reference kernel
    # :105-116 — the x conditions carry "&& !x_offset", the y ones do not).
    if wrap:
        u_lo2 = torch.where((lo < 0) & ~offset, u_hi, u_lo)
        u_hi2 = torch.where((hi >= out_dim) & ~offset, u_lo2, u_hi)
    else:
        u_lo2 = torch.where(lo < 0, u_hi, u_lo)
        u_hi2 = torch.where(hi >= out_dim, u_lo2, u_hi)

    # Exact integer blend fraction; zero-width cells (hi == lo) force
    # num = 0, giving 0/1 (the reference blends toward the lo tap there).
    den = torch.clamp_min(hi - lo, 1)
    num = torch.where(hi == lo, 0, torch.minimum((pw - lo).clamp_min(0), den))
    ratio = num.to(torch.float32) / den.to(torch.float32)

    half_r = reduced_dim // 2

    def clampr(v):
        return (v + half_r).clamp(0, reduced_dim - 1).to(torch.int32)

    return (
        clampr(u_lo2), clampr(u_hi2), ratio, num.to(torch.int32),
        den.to(torch.int32), maxstep,
    )


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's CPU backend contracts
    the exact blend into FMAs.  The product of two float32 values is exact
    in float64; the float64 sum then rounds to float32, which equals the
    FMA unless that sum itself had to round onto a float32 tie."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def unwarp_rect(
    reduced: torch.Tensor,
    out_width: int,
    out_height: int,
    center: torch.Tensor,
    *,
    in_layout: str = "hwc",
    out_layout: str = "hwc",
    precision: str = "exact",
) -> torch.Tensor:
    """Unwarp a reduced uint8 frame back to (out_height, out_width).

    ``center`` is float32 (2,) in [0, 1] on the frame's device.  Layouts:
    "hwc" (H, W, 3) or channel-planar "chw" (3, H, W).  ``precision`` is
    one of :data:`PRECISIONS` (module docstring).
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown unwarp precision {precision!r}")
    if precision != "exact":
        from foveax_torch.kernels.unwarp import unwarp_rect_fused

        out = unwarp_rect_fused(
            reduced, out_width, out_height, center,
            in_layout=in_layout, out_layout=out_layout,
            strict=precision == "fused",
        )
        if out is not None:
            return out
    planar = reduced.permute(2, 0, 1) if in_layout == "hwc" else reduced
    _, hr, wr = planar.shape
    with profiling.span("unwarp.vectors"):
        cx, cy = scaled_center(center, out_width, out_height)
        ix_lo, ix_hi, rx, _, _, _ = _axis_vectors(out_width, wr, cx, wrap=True)
        iy_lo, iy_hi, ry, _, _, _ = _axis_vectors(out_height, hr, cy, wrap=False)

    ry2 = ry[None, :, None]
    rx2 = rx[None, None, :]
    rows_lo = planar.index_select(1, iy_lo)  # (3, Ho, Wr) u8
    rows_hi = planar.index_select(1, iy_hi)
    tl = rows_lo.index_select(2, ix_lo).to(torch.float32)
    tr = rows_lo.index_select(2, ix_hi).to(torch.float32)
    bl = rows_hi.index_select(2, ix_lo).to(torch.float32)
    br = rows_hi.index_select(2, ix_hi).to(torch.float32)
    left = _fma(bl - tl, ry2, tl)
    right = _fma(br - tr, ry2, tr)
    out = _fma(right - left, rx2, left).to(torch.uint8)

    if out_layout == "chw":
        return out
    return out.permute(1, 2, 0).contiguous()
