"""Fused segment-reduce sampler (counterpart of
``foveax/kernels/segreduce.py``): two passes, each a hand-written CUDA
kernel (``csrc/segreduce.cu``) with a plain PyTorch twin.

- K1, :func:`y_segment_reduce_batch` (replaces ``segreduce.py:_y_kernel``):
  (3, H, W) uint8 + per-gaze row taps (N, Hr) -> (N, 3, Hr, W) uint16,
  row j holding the sum of source rows ``(pmc[j], pc[j]]``.
- K2, :func:`x_segment_reduce_batch` (replaces ``segreduce.py:_x_kernel``):
  the row sums + per-gaze column taps (N, Wr) -> (N, 3, Hr, Wr) uint8, the
  exact box mean ``floor(box / (dy*dx))``, 0 where the cell's row or
  column is invalid.

The results are gaze-major, so a batch's channel-planar output needs no
copy.  Both passes are bound by bytes on the card (see the source note).
A wrapper runs the plain version for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  The result is bit-identical to the JAX
package's ``sample_rect_fused`` and to its SAT path (same box semantics:
reference src/sat_decoder_sample_rect_kernel.cl:138-241).
"""

from __future__ import annotations

import torch

from foveax_torch.core.logrect import LogRectGrid, scaled_center
from foveax_torch.core.sample import _axis_taps, _exact_box_div
from foveax_torch.kernels.build import I, P, Kernel, check_tensor

Y_PASS = Kernel("segreduce", "fvx_y_segment_reduce", [P, P, P, P, I, I, I, I])
X_PASS = Kernel(
    "segreduce", "fvx_x_segment_reduce", [P, P, P, P, P, P, P, P, I, I, I, I]
)


def y_segment_reduce_batch_plain(
    frame: torch.Tensor, pmc: torch.Tensor, pc: torch.Tensor
) -> torch.Tensor:
    """Plain K1: int64 prefix sums down the rows, two row gathers."""
    _, _, w = frame.shape
    n, hr = pc.shape
    cs = frame.to(torch.int64).cumsum(1)  # (3, H, W) inclusive
    hi = cs.index_select(1, pc.reshape(-1).long())
    lo = cs.index_select(1, pmc.reshape(-1).long())
    rows = (hi - lo).reshape(3, n, hr, w).transpose(0, 1)
    return rows.to(torch.uint16).contiguous()


def y_segment_reduce_batch(
    frame: torch.Tensor, pmc: torch.Tensor, pc: torch.Tensor
) -> torch.Tensor:
    """(3, H, W) uint8 + row taps (N, Hr) int32 -> (N, 3, Hr, W) uint16.

    Row j of gaze g is the sum of frame rows ``(pmc[g, j], pc[g, j]]``
    (the y half of the 4-tap box filter).  The taps must satisfy the
    clamp rule ``1 <= pc <= H-1``, ``0 <= pmc < pc``, and no interval may
    hold 2^16 / 255 rows or more (:func:`fused_eligible`).
    """
    if frame.device.type == "cpu":
        return y_segment_reduce_batch_plain(frame, pmc, pc)
    _, h, w = frame.shape
    n, hr = pc.shape
    dev = frame.device
    check_tensor(frame, "frame", torch.uint8, (3, h, w), dev)
    check_tensor(pc, "pc", torch.int32, (n, hr), dev)
    check_tensor(pmc, "pmc", torch.int32, (n, hr), dev)
    out = torch.empty((n, 3, hr, w), dtype=torch.uint16, device=dev)
    if out.numel():
        Y_PASS.launch(
            frame.data_ptr(), pc.data_ptr(), pmc.data_ptr(), out.data_ptr(),
            n, h, w, hr,
        )
    return out


def x_segment_reduce_batch_plain(
    rows: torch.Tensor,
    pxmc: torch.Tensor,
    pxc: torch.Tensor,
    valid_x: torch.Tensor,
    pymc: torch.Tensor,
    pyc: torch.Tensor,
    valid_y: torch.Tensor,
) -> torch.Tensor:
    """Plain K2: int64 prefix sums along the row sums, two column
    gathers, exact floor division, validity mask."""
    n, _, hr, _ = rows.shape
    wr = pxc.shape[1]
    cs = rows.to(torch.int64).cumsum(3)  # (N, 3, Hr, W) inclusive
    shape = (n, 3, hr, wr)
    hi = cs.gather(3, pxc.long()[:, None, None, :].expand(shape))
    lo = cs.gather(3, pxmc.long()[:, None, None, :].expand(shape))
    dy = (pyc - pymc).long()[:, None, :, None]
    dx = (pxc - pxmc).long()[:, None, None, :]
    q = _exact_box_div(hi - lo, dy * dx)
    valid = valid_y[:, None, :, None] & valid_x[:, None, None, :]
    return torch.where(valid, q, 0).to(torch.uint8)


def x_segment_reduce_batch(
    rows: torch.Tensor,
    pxmc: torch.Tensor,
    pxc: torch.Tensor,
    valid_x: torch.Tensor,
    pymc: torch.Tensor,
    pyc: torch.Tensor,
    valid_y: torch.Tensor,
) -> torch.Tensor:
    """(N, 3, Hr, W) uint16 row sums + column taps (N, Wr) int32 ->
    (N, 3, Hr, Wr) uint8: the box mean over ``(pxmc, pxc]`` x
    ``(pymc, pyc]``, 0 where the cell's row or column is invalid.  The
    column taps obey the same clamp rule as the row taps."""
    if rows.device.type == "cpu":
        return x_segment_reduce_batch_plain(
            rows, pxmc, pxc, valid_x, pymc, pyc, valid_y
        )
    n, _, hr, w = rows.shape
    wr = pxc.shape[1]
    dev = rows.device
    check_tensor(rows, "rows", torch.uint16, (n, 3, hr, w), dev)
    for name, t in (("pxc", pxc), ("pxmc", pxmc)):
        check_tensor(t, name, torch.int32, (n, wr), dev)
    for name, t in (("pyc", pyc), ("pymc", pymc)):
        check_tensor(t, name, torch.int32, (n, hr), dev)
    check_tensor(valid_x, "valid_x", torch.bool, (n, wr), dev)
    check_tensor(valid_y, "valid_y", torch.bool, (n, hr), dev)
    out = torch.empty((n, 3, hr, wr), dtype=torch.uint8, device=dev)
    if out.numel():
        X_PASS.launch(
            rows.data_ptr(), pxc.data_ptr(), pxmc.data_ptr(),
            valid_x.data_ptr(), pyc.data_ptr(), pymc.data_ptr(),
            valid_y.data_ptr(), out.data_ptr(), n, hr, w, wr,
        )
    return out


def fused_eligible(grid: LogRectGrid) -> bool:
    """The fused sampler's structural contract: every row interval's sum
    of uint8 pixels fits the uint16 row sums, 255 * max(dy) < 2^16 (the
    bound the JAX package's y pass relies on too)."""
    return 255 * grid.max_dy < 2**16


def fused_taps(grid: LogRectGrid, frame: torch.Tensor, centers: torch.Tensor,
               *, wrap_x: bool = True):
    """Per-gaze taps for a (3, H, W) frame and (N, 2) float32 centres:
    ``(pxc, pxmc, valid_x)`` of shape (N, Wr) and ``(pyc, pymc,
    valid_y)`` of shape (N, Hr).  Raises ValueError where the shape is
    outside the fused sampler's contract."""
    if not fused_eligible(grid):
        raise ValueError(
            f"fused sampler: row step {grid.max_dy} overflows the uint16 "
            "row sums (needs 255 * max(dy) < 2^16)"
        )
    _, hs, ws = frame.shape
    cx, cy = scaled_center(centers, ws, hs)  # (N,)
    pxc, pxmc, valid_x = _axis_taps(grid.gx, cx[:, None], ws, wrap=wrap_x)
    pyc, pymc, valid_y = _axis_taps(grid.gy, cy[:, None], hs, wrap=False)
    return pxc, pxmc, valid_x, pyc, pymc, valid_y


def sample_rect_fused_batch(
    frame: torch.Tensor,
    grid: LogRectGrid,
    centers: torch.Tensor,
    *,
    wrap_x: bool = True,
    in_layout: str = "chw",
    out_layout: str = "hwc",
) -> torch.Tensor:
    """N gazes (``centers``: (N, 2) float32 in [0, 1]) against one shared
    frame, one launch of each kernel for the whole batch.  Returns
    (N, Hr, Wr, 3) for "hwc", (N, 3, Hr, Wr) for "chw"."""
    if in_layout == "hwc":
        frame = frame.permute(2, 0, 1)
    frame = frame.contiguous()
    pxc, pxmc, valid_x, pyc, pymc, valid_y = fused_taps(
        grid, frame, centers, wrap_x=wrap_x
    )
    rows = y_segment_reduce_batch(frame, pymc, pyc)
    out = x_segment_reduce_batch(rows, pxmc, pxc, valid_x, pymc, pyc, valid_y)
    if out_layout == "chw":
        return out
    return out.permute(0, 2, 3, 1).contiguous()


def sample_rect_fused(
    frame: torch.Tensor,
    grid: LogRectGrid,
    center: torch.Tensor,
    *,
    wrap_x: bool = True,
    in_layout: str = "chw",
    out_layout: str = "hwc",
) -> torch.Tensor:
    """Foveate one frame at one gaze (``center``: (2,) float32): the N = 1
    case of :func:`sample_rect_fused_batch`."""
    out = sample_rect_fused_batch(
        frame, grid, center[None], wrap_x=wrap_x, in_layout=in_layout,
        out_layout=out_layout,
    )
    return out[0]
