"""Fused unwarp (counterpart of ``foveax/kernels/unwarp_pl.py`` in its
default xy order): two passes, each a hand-written CUDA kernel
(``csrc/unwarp.cu``) with a plain PyTorch twin.

- K3, :func:`unwarp_x_pass` (replaces ``unwarp_pl.py:_x_kernel``):
  (3, hr, wr) uint8 -> (3, hr, Wo) uint8, each output column the integer-
  weight blend of two reduced columns, rounded half up
  (``trunc(numi * fl(1/den) + 0.5 + 2^-10)``).
- K4, :func:`unwarp_y_pass` (replaces ``unwarp_pl.py:_y_kernel``):
  (3, hr, Wo) -> (3, Ho, Wo) uint8, the same blend over two rows, truncated
  with the +0.01 guard.

Both are bound by bytes on the card (see the source note).  The blend is
``numi = (den - num) * a + num * b`` in exact integers, then one float32
multiply by the IEEE reciprocal and one float32 add, each rounded (no
FMA), which is what the JAX package's kernels compute.  A wrapper runs the
kernel for a CUDA tensor and the plain version for a CPU tensor; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from foveax_torch.core.logrect import scaled_center
from foveax_torch.core.unwarp import _axis_vectors
from foveax_torch.kernels.build import I, P, Kernel, check_tensor

X_PASS = Kernel("unwarp", "fvx_unwarp_x", [P, P, P, P, P, P, I, I, I])
Y_PASS = Kernel("unwarp", "fvx_unwarp_y", [P, P, P, P, P, P, I, I, I])

HALF_UP = np.float32(0.5 + 2.0**-10)
TRUNC_GUARD = np.float32(0.01)


def _blend_plain(a, b, num, den, bias: np.float32) -> torch.Tensor:
    numi = (den - num) * a.to(torch.int32) + num * b.to(torch.int32)
    q = numi.to(torch.float32) * (1.0 / den.to(torch.float32))
    q = q + torch.tensor(bias, dtype=torch.float32, device=q.device)
    return q.to(torch.int32).to(torch.uint8)


def unwarp_x_pass_plain(src, lo, hi, num, den) -> torch.Tensor:
    """Plain K3: two column gathers and the rounded blend."""
    return _blend_plain(
        src.index_select(2, lo), src.index_select(2, hi), num[None, None, :],
        den[None, None, :], HALF_UP,
    )


def unwarp_y_pass_plain(src, lo, hi, num, den) -> torch.Tensor:
    """Plain K4: two row gathers and the truncated blend."""
    return _blend_plain(
        src.index_select(1, lo), src.index_select(1, hi), num[None, :, None],
        den[None, :, None], TRUNC_GUARD,
    )


def _launch_pass(kernel: Kernel, src, lo, hi, num, den, axis: int):
    """Check the operands of one pass, allocate its output (``src`` with
    dimension ``axis`` resized to the tap count) and launch it."""
    dev = src.device
    if src.dim() != 3 or src.shape[0] != 3:
        raise ValueError(f"src: expected (3, H, W), got {tuple(src.shape)}")
    check_tensor(src, "src", torch.uint8, src.shape, dev)
    n = lo.shape[0]
    for name, t in (("lo", lo), ("hi", hi), ("num", num), ("den", den)):
        check_tensor(t, name, torch.int32, (n,), dev)
    _, h, w = src.shape
    out_shape = (3, h, n) if axis == 2 else (3, n, w)
    out = torch.empty(out_shape, dtype=torch.uint8, device=dev)
    if out.numel():
        kernel.launch(
            src.data_ptr(), lo.data_ptr(), hi.data_ptr(), num.data_ptr(),
            den.data_ptr(), out.data_ptr(), h, w, n,
        )
    return out


def unwarp_x_pass(src, lo, hi, num, den) -> torch.Tensor:
    """(3, hr, wr) uint8 + per-column (lo, hi, num, den) (Wo,) int32 ->
    (3, hr, Wo) uint8.  ``lo``/``hi`` must lie in [0, wr), ``den`` in
    [1, 255] and ``num`` in [0, den]."""
    if src.device.type == "cpu":
        return unwarp_x_pass_plain(src, lo, hi, num, den)
    return _launch_pass(X_PASS, src, lo, hi, num, den, axis=2)


def unwarp_y_pass(src, lo, hi, num, den) -> torch.Tensor:
    """(3, hr, Wo) uint8 + per-row (lo, hi, num, den) (Ho,) int32 ->
    (3, Ho, Wo) uint8, with the same bounds along the rows."""
    if src.device.type == "cpu":
        return unwarp_y_pass_plain(src, lo, hi, num, den)
    return _launch_pass(Y_PASS, src, lo, hi, num, den, axis=1)


def fused_vectors(hr: int, wr: int, out_width: int, out_height: int,
                  center: torch.Tensor):
    """The per-axis inputs of the two passes for one gaze: ``(ix_lo,
    ix_hi, nx, dx)`` of shape (out_width,) and ``(iy_lo, iy_hi, ny, dy)``
    of shape (out_height,), int32 on the centre's device.  Raises
    ValueError where a delta step exceeds 255 (the exactness argument of
    the float step needs den <= 255)."""
    cx, cy = scaled_center(center, out_width, out_height)
    ix_lo, ix_hi, _, nx, dx, msx = _axis_vectors(out_width, wr, cx, wrap=True)
    iy_lo, iy_hi, _, ny, dy, msy = _axis_vectors(out_height, hr, cy, wrap=False)
    if max(msx, msy) > 255:
        raise ValueError("fused unwarp needs delta steps <= 255")
    return (ix_lo, ix_hi, nx, dx), (iy_lo, iy_hi, ny, dy)


def unwarp_rect_fused(
    reduced: torch.Tensor,
    out_width: int,
    out_height: int,
    center: torch.Tensor,
    *,
    in_layout: str = "hwc",
    out_layout: str = "hwc",
) -> torch.Tensor:
    """Unwarp a reduced uint8 frame to (out_height, out_width) through the
    two fused passes: bit-identical to the JAX package's
    ``unwarp_rect_fused`` (xy order), within 1 LSB of the exact unwarp,
    fovea bit-exact."""
    planar = reduced.permute(2, 0, 1) if in_layout == "hwc" else reduced
    planar = planar.contiguous()
    _, hr, wr = planar.shape
    xv, yv = fused_vectors(hr, wr, out_width, out_height, center)
    out = unwarp_y_pass(unwarp_x_pass(planar, *xv), *yv)
    return out if out_layout == "chw" else out.permute(1, 2, 0).contiguous()
