"""Gaze-centred log-rectilinear box-filter taps (counterpart of
``foveax/core/sample.py``).

Because the grid is separable, every tap coordinate is a 1-D vector:
``pc``/``pmc`` over output columns (x axis) or rows (y axis).  The box of
output cell (j, i) is the source interval ``(pmc, pc]`` on each axis
(reference: src/sat_decoder_sample_rect_kernel.cl:138-241).  The gaze
enters as a runtime tensor added to the grid, so a moving gaze rebuilds
nothing.

The shared-tap ``q``/``fix`` outputs of the JAX ``_axis_taps`` serve only
the SAT gather path, which a later part of the port brings.
"""

from __future__ import annotations

import torch


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
