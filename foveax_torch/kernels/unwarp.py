"""Fused unwarp (counterpart of ``foveax/kernels/unwarp_pl.py`` in its
default xy order): one hand-written CUDA kernel (``csrc/unwarp.cu``) with a
plain PyTorch twin.

:func:`unwarp_xy` (replaces ``unwarp_pl.py:_x_kernel`` and ``_y_kernel``):
(3, hr, wr) uint8 -> (3, Ho, Wo) uint8 in one launch.  Its plain version
is the two passes it fuses:

- :func:`unwarp_x_pass_plain`: each output column the integer-weight blend
  of two reduced columns, rounded half up
  (``trunc(numi * fl(1/den) + 0.5 + 2^-10)``), giving (3, hr, Wo);
- :func:`unwarp_y_pass_plain`: the same blend over two rows of that,
  truncated with the +0.01 guard.

The kernel keeps the column-blended rows in shared memory, a band of
:data:`BAND_ROWS` output rows at a time, and is bound by bytes on the card
(see the source note).  The blend is ``numi = (den - num) * a + num * b`` in
exact integers, then one float32 multiply by the IEEE reciprocal and one
float32 add, each rounded (no FMA), which is what the JAX package's kernels
compute.  The wrapper runs the kernel for a CUDA tensor and the plain
version for a CPU tensor; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from foveax_torch.core.logrect import scaled_center
from foveax_torch.core.unwarp import _axis_tables, _axis_vectors
from foveax_torch.kernels.build import I, P, Kernel, check_tensor
from foveax_torch.pipeline import profiling

UNWARP_XY = Kernel("unwarp", "fvx_unwarp_xy", [P] * 10 + [I] * 5)

# Output rows per block band.  The inverse map's vectors make a band's taps
# span at most BAND_ROWS + 1 reduced rows, which the kernel stages on chip.
BAND_ROWS = 64
# The fused contract: the float step is exact only for den <= 255.
FUSED_MAX_STEP = 255

HALF_UP = np.float32(0.5 + 2.0**-10)
TRUNC_GUARD = np.float32(0.01)


def _blend_plain(a, b, num, den, bias: np.float32) -> torch.Tensor:
    numi = (den - num) * a.to(torch.int32) + num * b.to(torch.int32)
    q = numi.to(torch.float32) * (1.0 / den.to(torch.float32))
    q = q + torch.tensor(bias, dtype=torch.float32, device=q.device)
    return q.to(torch.int32).to(torch.uint8)


def unwarp_x_pass_plain(src, lo, hi, num, den) -> torch.Tensor:
    """The column pass: two column gathers and the rounded blend."""
    return _blend_plain(
        src.index_select(2, lo), src.index_select(2, hi), num[None, None, :],
        den[None, None, :], HALF_UP,
    )


def unwarp_y_pass_plain(src, lo, hi, num, den) -> torch.Tensor:
    """The row pass: two row gathers and the truncated blend."""
    return _blend_plain(
        src.index_select(1, lo), src.index_select(1, hi), num[None, :, None],
        den[None, :, None], TRUNC_GUARD,
    )


def unwarp_xy_plain(planar, xv, yv) -> torch.Tensor:
    """Plain version of :func:`unwarp_xy`: the column pass, then the row
    pass."""
    return unwarp_y_pass_plain(unwarp_x_pass_plain(planar, *xv), *yv)


def unwarp_xy(planar, xv, yv) -> torch.Tensor:
    """(3, hr, wr) uint8 + x vectors ``(lo, hi, num, den)``, each (Wo,)
    int32, + y vectors of the same kind, each (Ho,) -> (3, Ho, Wo) uint8.
    ``lo``/``hi`` must lie in [0, wr) (x) and [0, hr) (y), ``den`` in
    [1, 255] and ``num`` in [0, den]."""
    if planar.device.type == "cpu":
        return unwarp_xy_plain(planar, xv, yv)
    dev = planar.device
    if planar.dim() != 3 or planar.shape[0] != 3:
        raise ValueError(f"planar: expected (3, H, W), got {tuple(planar.shape)}")
    check_tensor(planar, "planar", torch.uint8, planar.shape, dev)
    _, hr, wr = planar.shape
    wo, ho = xv[0].shape[0], yv[0].shape[0]
    for axis, vecs, n in (("x", xv, wo), ("y", yv, ho)):
        for name, t in zip(("lo", "hi", "num", "den"), vecs, strict=True):
            check_tensor(t, f"{axis}_{name}", torch.int32, (n,), dev)
    out = torch.empty((3, ho, wo), dtype=torch.uint8, device=dev)
    if out.numel():
        with torch.cuda.device(dev):
            UNWARP_XY.launch(
                planar.data_ptr(), *(t.data_ptr() for t in (*xv, *yv)),
                out.data_ptr(), hr, wr, ho, wo, BAND_ROWS,
            )
    return out


def fused_vectors(hr: int, wr: int, out_width: int, out_height: int,
                  center: torch.Tensor, *, strict: bool = True):
    """The per-axis inputs of :func:`unwarp_xy` for one gaze: ``(ix_lo,
    ix_hi, nx, dx)`` of shape (out_width,) and ``(iy_lo, iy_hi, ny, dy)``
    of shape (out_height,), int32 on the centre's device.

    Outside the fused contract (an axis's delta step above
    :data:`FUSED_MAX_STEP`, a host integer of the cached tables: no device
    sync) it raises ValueError, or returns None where not ``strict``.  An
    ``unwarp.vectors`` span."""
    with profiling.span("unwarp.vectors"):
        dev = center.device
        steps = (_axis_tables(out_width, wr, True, dev)[3],
                 _axis_tables(out_height, hr, False, dev)[3])
        if max(steps) > FUSED_MAX_STEP:
            if strict:
                raise ValueError(
                    f"fused unwarp needs delta steps <= {FUSED_MAX_STEP}"
                )
            return None
        cx, cy = scaled_center(center, out_width, out_height)
        ix_lo, ix_hi, _, nx, dx, _ = _axis_vectors(out_width, wr, cx, wrap=True)
        iy_lo, iy_hi, _, ny, dy, _ = _axis_vectors(out_height, hr, cy, wrap=False)
        return (ix_lo, ix_hi, nx, dx), (iy_lo, iy_hi, ny, dy)


def unwarp_rect_fused(
    reduced: torch.Tensor,
    out_width: int,
    out_height: int,
    center: torch.Tensor,
    *,
    in_layout: str = "hwc",
    out_layout: str = "hwc",
    strict: bool = True,
) -> torch.Tensor | None:
    """Unwarp a reduced uint8 frame to (out_height, out_width) through the
    fused kernel: bit-identical to the JAX package's ``unwarp_rect_fused``
    (xy order), within 1 LSB of the exact unwarp, fovea bit-exact.
    Outside the fused contract it raises, or returns None where not
    ``strict`` (:func:`fused_vectors`).  The layout copies are
    ``unwarp.layout`` spans, the launch an ``unwarp.kernel`` span."""
    planar = reduced.permute(2, 0, 1) if in_layout == "hwc" else reduced
    _, hr, wr = planar.shape
    vectors = fused_vectors(hr, wr, out_width, out_height, center,
                            strict=strict)
    if vectors is None:
        return None
    with profiling.span("unwarp.layout", bytes=planar.numel()):
        planar = planar.contiguous()
    with profiling.span("unwarp.kernel"):
        out = unwarp_xy(planar, *vectors)
    del planar  # freed before the output's layout copy: one frame less at the peak
    if out_layout == "chw":
        return out
    with profiling.span("unwarp.layout", bytes=out.numel()):
        return out.permute(1, 2, 0).contiguous()
