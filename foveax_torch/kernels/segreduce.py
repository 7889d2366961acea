"""Fused segment-reduce sampler (counterpart of
``foveax/kernels/segreduce.py``): hand-written CUDA kernels
(``csrc/segreduce.cu``), each with a plain PyTorch twin.

- :func:`segment_reduce_xy_batch`, the sampler of the fused path (replaces
  both ``segreduce.py:_y_kernel`` and ``segreduce.py:_x_kernel`` in one
  launch): (3, H, W) uint8 + per-gaze column taps (N, Wr) and row taps
  (N, Hr) -> (N, 3, Hr, Wr) uint8, the exact box mean ``floor(box /
  (dy*dx))`` over ``(pxmc, pxc]`` x ``(pymc, pyc]``, 0 where the cell's
  row or column is invalid.  The row sums stay on chip.  Its plain version
  is the two passes below, composed.
- K1, :func:`y_segment_reduce_batch` (``segreduce.py:_y_kernel`` alone):
  (3, H, W) uint8 + row taps (N, Hr) -> (N, 3, Hr, W) uint16, row j
  holding the sum of source rows ``(pmc[j], pc[j]]``.
- K2, :func:`x_segment_reduce_batch` (``segreduce.py:_x_kernel`` alone):
  those row sums + column taps -> the (N, 3, Hr, Wr) uint8 box means.

K1 and K2 are the counterparts of the JAX package's two public pass
functions; no path of the port launches them.  The results are gaze-major,
so a batch's channel-planar output needs no copy.  The kernels are bound
by bytes on the card (see the source note).  A wrapper runs the plain
version for a CPU tensor; for a CUDA tensor it launches the kernel or
raises.  The result is bit-identical to the JAX package's
``sample_rect_fused`` and to its SAT path (same box semantics: reference
src/sat_decoder_sample_rect_kernel.cl:138-241).
"""

from __future__ import annotations

import torch

from foveax_torch.core.logrect import LogRectGrid
from foveax_torch.core.sample import _exact_box_div, gaze_taps
from foveax_torch.kernels.build import I, P, Kernel, check_tensor
from foveax_torch.pipeline import profiling

XY_PASS = Kernel("segreduce", "fvx_segment_reduce_xy", [P] * 8 + [I] * 6)
Y_PASS = Kernel("segreduce", "fvx_y_segment_reduce", [P, P, P, P, I, I, I, I])
X_PASS = Kernel(
    "segreduce", "fvx_x_segment_reduce", [P, P, P, P, P, P, P, P, I, I, I, I]
)

# Output rows per block of ``fvx_segment_reduce_xy``.  The block loads its
# gaze's column taps once for the band, but its rows run one after another:
# on the H100 one row a block beat two and four (PERF.md §6).
BAND_ROWS = 1
# Shared memory a block may use on the card (H100: 227 KB).
MAX_SHARED_BYTES = 232_448


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
        with torch.cuda.device(dev):
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
        with torch.cuda.device(dev):
            X_PASS.launch(
                rows.data_ptr(), pxc.data_ptr(), pxmc.data_ptr(),
                valid_x.data_ptr(), pyc.data_ptr(), pymc.data_ptr(),
                valid_y.data_ptr(), out.data_ptr(), n, hr, w, wr,
            )
    return out


def segment_reduce_xy_batch_plain(
    frame: torch.Tensor,
    pxmc: torch.Tensor,
    pxc: torch.Tensor,
    valid_x: torch.Tensor,
    pymc: torch.Tensor,
    pyc: torch.Tensor,
    valid_y: torch.Tensor,
) -> torch.Tensor:
    """Plain version of :func:`segment_reduce_xy_batch`: K1's plain pass,
    then K2's."""
    rows = y_segment_reduce_batch_plain(frame, pymc, pyc)
    return x_segment_reduce_batch_plain(
        rows, pxmc, pxc, valid_x, pymc, pyc, valid_y
    )


def xy_shared_bytes(w: int, wr: int) -> int:
    """Shared memory of a ``fvx_segment_reduce_xy`` block, as
    ``csrc/segreduce.cu`` lays it out: 16 warp totals, the uint32 prefix
    over the W source columns (one pad word per 16) and the packed column
    taps, each padded to 16 columns."""
    return 64 + 68 * -(-w // 16) + 64 * -(-wr // 16)


def segment_reduce_xy_batch(
    frame: torch.Tensor,
    pxmc: torch.Tensor,
    pxc: torch.Tensor,
    valid_x: torch.Tensor,
    pymc: torch.Tensor,
    pyc: torch.Tensor,
    valid_y: torch.Tensor,
) -> torch.Tensor:
    """(3, H, W) uint8 + column taps (N, Wr) + row taps (N, Hr) ->
    (N, 3, Hr, Wr) uint8 in one launch: the box mean over ``(pxmc, pxc]``
    x ``(pymc, pyc]``, 0 where the cell's row or column is invalid.  The
    taps obey the clamp rule ``1 <= pc <= dim-1``, ``0 <= pmc < pc`` on
    each axis.  The kernel sums in uint32 (exact while 255*dy*dx < 2^32);
    the plain version, K1's uint16 row sums, needs 255*dy < 2^16 as well
    (:func:`fused_eligible`)."""
    if frame.device.type == "cpu":
        return segment_reduce_xy_batch_plain(
            frame, pxmc, pxc, valid_x, pymc, pyc, valid_y
        )
    _, h, w = frame.shape
    n, wr = pxc.shape
    hr = pyc.shape[1]
    dev = frame.device
    check_tensor(frame, "frame", torch.uint8, (3, h, w), dev)
    for name, t in (("pxc", pxc), ("pxmc", pxmc)):
        check_tensor(t, name, torch.int32, (n, wr), dev)
    for name, t in (("pyc", pyc), ("pymc", pymc)):
        check_tensor(t, name, torch.int32, (n, hr), dev)
    check_tensor(valid_x, "valid_x", torch.bool, (n, wr), dev)
    check_tensor(valid_y, "valid_y", torch.bool, (n, hr), dev)
    smem = xy_shared_bytes(w, wr)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"segment_reduce_xy: source width {w} and output width {wr} need "
            f"{smem} bytes of shared memory per block, more than the card's "
            f"{MAX_SHARED_BYTES}"
        )
    out = torch.empty((n, 3, hr, wr), dtype=torch.uint8, device=dev)
    if out.numel():
        with torch.cuda.device(dev):
            XY_PASS.launch(
                frame.data_ptr(), pxc.data_ptr(), pxmc.data_ptr(),
                valid_x.data_ptr(), pyc.data_ptr(), pymc.data_ptr(),
                valid_y.data_ptr(), out.data_ptr(), n, h, w, hr, wr, BAND_ROWS,
            )
    return out


def fused_eligible(grid: LogRectGrid) -> bool:
    """The fused sampler's contract: every row interval's sum of uint8
    pixels fits the uint16 row sums, 255 * max(dy) < 2^16 (the bound the
    JAX package's y pass relies on too), and a ``segment_reduce_xy`` block
    fits the card's shared memory (:func:`xy_shared_bytes`; under the
    reduced-size rule up to 35,888 source columns).  Host arithmetic on
    the grid's own fields: the same on every device."""
    return (255 * grid.max_dy < 2**16
            and xy_shared_bytes(grid.source_width, grid.out_width)
            <= MAX_SHARED_BYTES)


def fused_taps(grid: LogRectGrid, frame: torch.Tensor, centers: torch.Tensor,
               *, wrap_x: bool = True):
    """Per-gaze taps for a (3, H, W) frame and (N, 2) float32 centres:
    ``(pxc, pxmc, valid_x)`` of shape (N, Wr) and ``(pyc, pymc,
    valid_y)`` of shape (N, Hr).  Raises ValueError where the shape is
    outside the fused sampler's contract."""
    if not fused_eligible(grid):
        raise ValueError(
            f"fused sampler: outside its contract, which needs row step "
            f"{grid.max_dy} to fit the uint16 row sums (255 * max(dy) < "
            f"2^16) and source width {grid.source_width} and output width "
            f"{grid.out_width} to need at most {MAX_SHARED_BYTES} bytes of "
            f"shared memory per segment_reduce_xy block (they need "
            f"{xy_shared_bytes(grid.source_width, grid.out_width)} bytes)"
        )
    _, hs, ws = frame.shape
    return gaze_taps(grid, hs, ws, centers, wrap_x=wrap_x)


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
    frame, one launch for the whole batch.  Returns (N, Hr, Wr, 3) for
    "hwc", (N, 3, Hr, Wr) for "chw".  The layout copies are
    ``sampler.layout`` spans, the launch a ``sampler.kernel`` span."""
    if in_layout == "hwc":
        frame = frame.permute(2, 0, 1)
    with profiling.span("sampler.layout", bytes=frame.numel()):
        frame = frame.contiguous()
    pxc, pxmc, valid_x, pyc, pymc, valid_y = fused_taps(
        grid, frame, centers, wrap_x=wrap_x
    )
    with profiling.span("sampler.kernel", kernel="segreduce_xy"):
        out = segment_reduce_xy_batch(
            frame, pxmc, pxc, valid_x, pymc, pyc, valid_y
        )
    if out_layout == "chw":
        return out
    with profiling.span("sampler.layout", bytes=out.numel()):
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
