"""Summed-area table build (counterpart of ``foveax/kernels/scan2d.py``):
K5, a hand-written CUDA kernel (``csrc/scan2d.cu``), with its plain
PyTorch twin.

K5, :func:`sat_scan` (replaces ``scan2d.py:_sat_kernel`` via
``build_sat_pallas``): a (H, W, 3) or (3, H, W) uint8 frame -> the (3, H,
W) inclusive SAT mod 2^32, stored as ``torch.uint32`` (the JAX package's
dtype and bits).  Unlike the TPU kernel it takes any H and W: there is no
128-lane or 8-row block constraint.

PyTorch stores ``uint32`` but does little arithmetic on it, and int32
arithmetic would wrap at 2^31, which the sums of a bright frame a little
above 4K pass (all-255 4096x2160: 2.26e9).  So the plain
version sums in int64 and keeps the low 32 bits; the kernel sums in
``uint32_t``.  A wrapper runs the plain version for a CPU tensor; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from foveax_torch.kernels.build import I, P, Kernel, check_tensor

SAT_BUILD = Kernel("scan2d", "fvx_sat_build", [P, I, I, I, P, I, I])

MASK32 = 0xFFFFFFFF


def low32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an int64 tensor, stored as ``torch.uint32``
    (through an int32 view: the cast keeps the bits)."""
    return (x & MASK32).to(torch.int32).view(torch.uint32)


def as_int64(sat: torch.Tensor) -> torch.Tensor:
    """A ``torch.uint32`` tensor's values in [0, 2^32) as int64."""
    return sat.view(torch.int32).to(torch.int64) & MASK32


def sat_scan_plain(planes_chw: torch.Tensor) -> torch.Tensor:
    """Plain K5: int64 cumsum along the columns, then along the rows."""
    return low32(planes_chw.to(torch.int64).cumsum(2).cumsum(1))


def sat_scan(frame: torch.Tensor, *, in_layout: str = "hwc") -> torch.Tensor:
    """(H, W, 3) uint8 ("hwc") or (3, H, W) ("chw") -> (3, H, W)
    ``torch.uint32`` inclusive SAT, mod 2^32."""
    if in_layout not in ("hwc", "chw"):
        raise ValueError(f"in_layout {in_layout!r}: expected 'hwc' or 'chw'")
    hwc = in_layout == "hwc" and frame.dim() == 3
    chw = frame.permute(2, 0, 1) if hwc else frame
    if frame.dim() != 3 or chw.shape[0] != 3:
        raise ValueError(
            f"frame: expected 3 channels in {in_layout!r} layout, got "
            f"{tuple(frame.shape)}"
        )
    if frame.device.type == "cpu":
        return sat_scan_plain(chw)
    check_tensor(frame, "frame", torch.uint8, frame.shape, frame.device)
    _, h, w = chw.shape
    out = torch.empty((3, h, w), dtype=torch.uint32, device=frame.device)
    if out.numel():
        c_stride, r_stride, x_stride = chw.stride()
        SAT_BUILD.launch(
            frame.data_ptr(), c_stride, r_stride, x_stride, out.data_ptr(),
            h, w,
        )
    return out
