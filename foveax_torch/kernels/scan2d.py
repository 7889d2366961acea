"""Summed-area table build (counterpart of ``foveax/kernels/scan2d.py``):
K5, a hand-written CUDA kernel (``csrc/scan2d.cu``), with its plain
PyTorch twin.

K5, :func:`sat_scan` (replaces ``scan2d.py:_sat_kernel`` via
``build_sat_pallas``): a (H, W, 3) or (3, H, W) uint8 frame -> the (3, H,
W) inclusive SAT mod 2^32, stored as ``torch.uint32`` (the JAX package's
dtype and bits).  Unlike the TPU kernel it takes any H and W: there is no
128-lane or 8-row block constraint.  The kernel works by row bands (band
totals, their carry down the bands, then one scan per band that writes the
SAT once), and past :data:`MAX_WIDTH` columns, which one scanning block
spans, its scan runs once per column tile, each starting from the last
SAT column of the tile before it; :func:`sat_plan` lays out its launch,
and K6 (``kernels/fused_select.py``) shares it.

PyTorch stores ``uint32`` but does little arithmetic on it, and int32
arithmetic would wrap at 2^31, which the sums of a bright frame a little
above 4K pass (all-255 4096x2160: 2.26e9).  So the plain
version sums in int64 and keeps the low 32 bits; the kernel sums in
``uint32_t``.  A wrapper runs the plain version for a CPU tensor; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from foveax_torch.kernels.build import I, P, Kernel, check_tensor

SAT_BUILD = Kernel("scan2d", "fvx_sat_build", [P, I, I, I, P, P] + [I] * 5)

MASK32 = 0xFFFFFFFF

# Rows of a band: the unit of the carry down the frame and of one scanning
# block.  Taller bands mean fewer, longer blocks and less band-total
# scratch; shorter ones more blocks in flight but a longer carry scan.
# Chosen on the H100 at 4K from scripts/sat_band_sweep.py (PERF.md §6):
# 3 * 68 = 204 scanning blocks, one wave at two blocks an SM.
BAND_ROWS = 32
CHUNK = 16          # columns a thread owns per chunk
MAX_THREADS = 512   # threads of a scanning block, which spans the row
MAX_CHUNKS_PER_THREAD = 4
# Columns a scanning block spans; a wider row is scanned in column tiles.
MAX_WIDTH = MAX_THREADS * MAX_CHUNKS_PER_THREAD * CHUNK  # 32,768
# Shared memory a block may use on the card (H100: 227 KB).
MAX_SHARED_BYTES = 232_448


class SatPlan(NamedTuple):
    """The host-side launch plan of K5 and K6 (``csrc/scan2d.cu``)."""

    band_rows: int
    chunks_per_thread: int
    threads: int  # a scanning block's, spanning one column tile
    step_rows: int  # rows a scanning step keeps in registers
    scratch_words: int  # uint32 band totals, (3, bands - 1, W padded to 16)
    shared_bytes: int  # dynamic shared memory of a scanning block
    launches: int  # CUDA launches a K5 call makes (K6: one more)
    tiles: int  # column tiles of MAX_WIDTH columns (the last one ragged)


def sat_plan(h: int, w: int, *, column_stride: int = 1) -> SatPlan:
    """The launch plan for an H x W frame whose columns lie
    ``column_stride`` bytes apart (1 for planes, 3 for interleaved
    pixels), as ``csrc/scan2d.cu`` lays it out: the row is cut into column
    tiles of :data:`MAX_WIDTH` columns."""
    if h < 1 or w < 1:
        raise ValueError(f"SAT kernels: empty {w}x{h} frame")
    tiles = -(-w // MAX_WIDTH)
    chunks = -(-min(w, MAX_WIDTH) // CHUNK)
    k = 1
    while chunks > k * MAX_THREADS:
        k *= 2
    threads = -(-(-(-chunks // k)) // 32) * 32  # ceil(chunks / k), to a warp
    step = max((4 if column_stride == 1 else 2) // k, 1)
    bands = -(-h // BAND_ROWS)
    # Words: the warp totals of two steps, each warp's staging buffer (20
    # words per 16 columns), K6's two row tables (see csrc/scan2d.cu).
    shared = 4 * (2 * step * (MAX_THREADS // 32) + threads * k * 20
                  + 2 * (BAND_ROWS + 1))
    return SatPlan(
        band_rows=BAND_ROWS, chunks_per_thread=k, threads=threads,
        step_rows=step, scratch_words=3 * (bands - 1) * -(-w // CHUNK) * CHUNK,
        shared_bytes=shared, launches=(0 if bands == 1 else 2) + tiles,
        tiles=tiles,
    )


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
        if max(c_stride, r_stride) >= 2**31:
            raise ValueError(
                f"frame: strides {chw.stride()} do not fit the kernel's int"
            )
        plan = sat_plan(h, w, column_stride=x_stride)
        totals = torch.empty(
            plan.scratch_words, dtype=torch.uint32, device=frame.device
        )
        with torch.cuda.device(frame.device):
            SAT_BUILD.launch(
                frame.data_ptr(), c_stride, r_stride, x_stride, out.data_ptr(),
                totals.data_ptr(), h, w, plan.band_rows, plan.threads,
                plan.chunks_per_thread,
            )
    return out
