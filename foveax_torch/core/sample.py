"""Gaze-centred log-rectilinear box-filter taps (counterpart of
``foveax/core/sample.py``).

Because the grid is separable, every tap coordinate is a 1-D vector:
``pc``/``pmc`` over output columns (x axis) or rows (y axis).  The box of
output cell (j, i) is the source interval ``(pmc, pc]`` on each axis
(reference: src/sat_decoder_sample_rect_kernel.cl:138-241).  The gaze
enters as a runtime tensor added to the grid, so a moving gaze rebuilds
nothing.

:func:`sample_rect_from_sat` is the SAT path's 4-tap sampler.  The JAX
package's shared-tap gathers (``q``/``fix`` of its ``_axis_taps``, the
``top_k`` fixup and the uint16 row bands) halve the traffic through the
TPU's slow gather engine; the port reaches the same integers with plain
indexed gathers, so those outputs are not carried over.
"""

from __future__ import annotations

import torch

from foveax_torch.core.logrect import LogRectGrid, scaled_center
from foveax_torch.kernels.scan2d import MASK32


def _exact_box_div(box: torch.Tensor, rect: torch.Tensor) -> torch.Tensor:
    """Exact ``floor(box / rect)`` for non-negative integer boxes and
    positive rects (what the JAX package's float estimate plus one-step
    fixup computes); integer floor division is exact as it stands."""
    return torch.div(box, rect, rounding_mode="floor")


def _axis_taps(g: torch.Tensor, c: torch.Tensor, dim: int, *, wrap: bool):
    """Per-axis tap vectors for one axis of the 4-tap box filter.

    ``g`` is the (N+1,) int16 grid vector, ``c`` the int32 scaled centre:
    a scalar, or (B, 1) for B gazes at once.  Returns ``(pc, pmc, valid)``,
    each (N,) (or (B, N)): the elementwise-clamped hi/lo tap indices and
    the validity mask.
    """
    p = c.to(torch.int32) + g.to(torch.int32)  # (N+1,)
    px, pxm = p[..., 1:], p[..., :-1]

    if wrap:
        # Elementwise 360 wrap: only when BOTH edges fall off the same side
        # (reference: src/sat_decoder_sample_rect_kernel.cl:181-187).
        wrap_hi = (px >= dim) & (pxm >= dim)
        wrap_lo = (px < 0) & (pxm < 0)
        shift = torch.where(wrap_hi, -dim, torch.where(wrap_lo, dim, 0))
        px = px + shift
        pxm = pxm + shift

    valid = ((px >= 0) & (px < dim)) | ((pxm >= 0) & (pxm < dim))

    # Clamp rule: pos into [1, dim-1], pos_minus into [0, pos-1] (reference:
    # src/sat_decoder_sample_rect_kernel.cl:201-204).  Source row 0 and
    # column 0 therefore never enter a box, a quirk of the reference kept
    # here.
    pc = px.clamp(1, dim - 1)
    pmc = torch.minimum(pxm.clamp_min(0), pc - 1)
    return pc.to(torch.int32), pmc.to(torch.int32), valid


def sample_rect_from_sat(
    sat: torch.Tensor,
    grid: LogRectGrid,
    center: torch.Tensor,
    *,
    wrap_x: bool = True,
    out_layout: str = "hwc",
    taps: str = "shared",
) -> torch.Tensor:
    """Foveate from a SAT: (3, Hs, Ws) ``torch.uint32`` SAT -> reduced
    uint8 frame, (Ho, Wo, 3) for "hwc" or (3, Ho, Wo) for "chw".

    ``center`` is a float32 (2,) tensor (cx, cy) in [0, 1], or (N, 2) for
    N gazes against the one SAT, which puts a leading N on the result.
    ``wrap_x`` enables the 360-degree horizontal wrap.  Invalid texels are
    0.  ``taps`` "shared" or "paired" name the JAX package's two gather
    schemes; both give these integers, which are computed here by two row
    gathers and four column gathers on the SAT's int32 view, the 4-tap
    difference in int64 mod 2^32 and the exact box division.
    """
    if taps not in ("shared", "paired"):
        raise ValueError(f"taps {taps!r}: expected 'shared' or 'paired'")
    _, hs, ws = sat.shape
    c = center.reshape(-1, 2)
    n = c.shape[0]
    cx, cy = scaled_center(c, ws, hs)  # (N,)
    pxc, pxmc, valid_x = _axis_taps(grid.gx, cx[:, None], ws, wrap=wrap_x)
    pyc, pymc, valid_y = _axis_taps(grid.gy, cy[:, None], hs, wrap=False)
    ho, wo = pyc.shape[1], pxc.shape[1]

    s = sat.view(torch.int32)

    def rows(idx):  # (3, N, Ho, Ws) int32
        return s.index_select(1, idx.reshape(-1)).reshape(3, n, ho, ws)

    def cols(r, idx):  # (3, N, Ho, Wo), the uint32 values mod 2^32
        idx = idx.long()[None, :, None, :].expand(3, n, ho, wo)
        return r.gather(3, idx).to(torch.int64)

    hi, lo = rows(pyc), rows(pymc)
    box = (
        cols(hi, pxc) - cols(lo, pxc) - cols(hi, pxmc) + cols(lo, pxmc)
    ) & MASK32  # a true box sum is below 2^32
    dy = (pyc - pymc).long()[None, :, :, None]
    rect = dy * (pxc - pxmc).long()[None, :, None, :]
    vals = _exact_box_div(box, rect)
    valid = valid_y[None, :, :, None] & valid_x[None, :, None, :]
    out = torch.where(valid, vals, 0).to(torch.uint8)
    order = (1, 0, 2, 3) if out_layout == "chw" else (1, 2, 3, 0)
    out = out.permute(order).contiguous()
    return out if center.dim() == 2 else out[0]
