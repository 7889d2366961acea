"""SAT-free direct sampler (counterpart of ``foveax/core/direct.py``).

The same function as :func:`~foveax_torch.core.sample.sample_rect_from_sat`
of a built SAT, bit-identical for centres in [0, 1]^2 (reference:
src/sat_decoder_sample_rect_kernel.cl:138-241), computed from the uint8
frame: no SAT is built and no kernel of the fused sampler runs.

Each output axis splits into at most three bands that depend only on the
grid (:func:`_axis_bands`): the longest run of cells whose grid step is 1
("crop", about 74% of the cells of an axis at the production shapes),
where a box is one source pixel wide on that axis even under the clamp
and the 360 wrap, and the periphery runs on either side of it ("box").
The y stage, then the x stage:

- crop rows: a gather of the source rows at the exact row taps;
- box rows: int32 prefix sums down the frame's columns (along the last
  axis of the transposed frame), differenced at the exact row taps (one
  row of box sums per output row);
- crop columns of those rows: a gather at the exact column taps, so the
  fovea (crop rows x crop columns) is a plain copy with no arithmetic;
- box columns: prefix sums along the rows (int64 where a box can pass
  2^31), differenced at the exact column taps;
- then the exact division by the box area, and 0 where a cell is invalid.

The JAX package computes the same bands with one-hot matmul tiles over
fixed windows for the TPU's matrix unit and gathers the crop band by a
positional map with a fixup at the frame edges and the seam.  Here every
index is an exact elementwise tap (:func:`~foveax_torch.core.sample._axis_taps`),
so there is no window, no fixup and no float arithmetic, and the result is
exact at every shape.  The gaze is a runtime tensor: bands and shapes come
from the grid alone, nothing is read back to the host, and a moving gaze
rebuilds nothing.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from foveax_torch.core.logrect import LogRectGrid
from foveax_torch.core.sample import _exact_box_div, gaze_taps, longest_run

# Minimum step-1 run worth a crop band (as in the JAX package); tiny grids
# take one box band per axis, which is exact at any size.
_MIN_CROP = 16


@dataclasses.dataclass(frozen=True)
class _Band:
    kind: str  # "crop" | "box"
    start: int  # first output cell (inclusive)
    end: int  # last output cell (exclusive)


@functools.lru_cache(maxsize=64)
def _axis_bands(g_bytes: bytes, dim: int) -> tuple[_Band, ...]:
    """Static band split of one axis from its int64 grid vector ``g``
    (N+1,): the crop band where the longest step-1 run holds the gaze
    (``g`` negative at its start), box bands before and after it.  The JAX
    package cuts each periphery run further into sub-bands of one matmul
    slab width, sized with the source extent ``dim``; the port has no
    slabs, so a periphery run is one band and ``dim`` does not enter."""
    g = np.frombuffer(g_bytes, dtype=np.int64)
    n = g.shape[0] - 1
    c0, c1 = longest_run(np.diff(g) == 1)
    if c1 - c0 < _MIN_CROP or g[c0] >= 0:
        return (_Band("box", 0, n),)
    bands = (_Band("box", 0, c0),) if c0 > 0 else ()
    bands += (_Band("crop", c0, c1),)
    return bands + ((_Band("box", c1, n),) if c1 < n else ())


@functools.lru_cache(maxsize=64)
def _axis_split(g_bytes: bytes, dim: int, device: torch.device):
    """(crop slice or None, box cells as an int64 index tensor on
    ``device`` or None) of one axis, built once per grid and device."""
    bands = _axis_bands(g_bytes, dim)
    crop = next((slice(b.start, b.end) for b in bands if b.kind == "crop"), None)
    box = [torch.arange(b.start, b.end) for b in bands if b.kind == "box"]
    return crop, (torch.cat(box).to(device) if box else None)


def _cols(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(3, N, R, W) gathered along W at per-gaze columns (N, K)."""
    c, n, r, _ = t.shape
    return t.gather(3, idx.long()[None, :, None, :].expand(c, n, r, idx.shape[1]))


def _x_stage(rows, dy, pxc, pxmc, xcrop, xbox, acc, wo: int) -> torch.Tensor:
    """The x stage of one row band: ``rows`` (3, N, R, W), source rows
    (uint8, ``dy`` None: boxes one row high) or box-row sums (int32, ``dy``
    (N, R) their heights) -> (3, N, R, Wo) uint8 box means."""
    c, n, r, _ = rows.shape
    out = torch.empty((c, n, r, wo), dtype=torch.uint8, device=rows.device)
    if xcrop is not None:
        box = _cols(rows, pxc[:, xcrop])
        if dy is not None:
            box = _exact_box_div(box, dy[None, :, :, None]).to(torch.uint8)
        out[..., xcrop] = box
    if xbox is not None:
        cs = rows.cumsum(3, dtype=acc)
        box = _cols(cs, pxc[:, xbox]) - _cols(cs, pxmc[:, xbox])
        rect = (pxc - pxmc)[:, None, xbox]  # (N, 1, K)
        if dy is not None:
            rect = dy[:, :, None] * rect
        out.index_copy_(3, xbox, _exact_box_div(box, rect[None]).to(torch.uint8))
    return out


def _sample_direct(frame, grid: LogRectGrid, centers, wrap_x: bool):
    """(3, Hs, Ws) uint8 + (N, 2) float32 centres -> (3, N, Ho, Wo)."""
    _, hs, ws = frame.shape
    n = centers.shape[0]
    dev = frame.device
    pxc, pxmc, valid_x, pyc, pymc, valid_y = gaze_taps(
        grid, hs, ws, centers, wrap_x=wrap_x
    )
    xcrop, xbox = _axis_split(grid.gx_host, ws, dev)
    ycrop, ybox = _axis_split(grid.gy_host, hs, dev)
    wo = grid.out_width
    # A box-row sum is at most 255 * max_dy (clamps only shrink a box); its
    # prefix along a row reaches 255 * max_dy * Ws.
    acc = torch.int64 if 255 * grid.max_dy * ws >= 2**31 else torch.int32

    out = torch.empty((3, n, grid.out_height, wo), dtype=torch.uint8, device=dev)
    if ycrop is not None:
        rows = frame.index_select(1, pyc[:, ycrop].reshape(-1)).view(3, n, -1, ws)
        out[:, :, ycrop] = _x_stage(rows, None, pxc, pxmc, xcrop, xbox, torch.int32, wo)
    if ybox is not None:
        # Inclusive prefix sums down the columns, taken along the last axis
        # of the transposed frame: on the card PyTorch scans any other axis
        # with one thread a column, one row after another.
        cs = frame.transpose(1, 2).cumsum(2, dtype=torch.int32)  # (3, Ws, Hs)
        hi = cs.index_select(2, pyc[:, ybox].reshape(-1))
        lo = cs.index_select(2, pymc[:, ybox].reshape(-1))
        sums = (hi - lo).view(3, ws, n, -1).permute(0, 2, 3, 1).contiguous()
        dy = (pyc - pymc)[:, ybox]
        out.index_copy_(2, ybox, _x_stage(sums, dy, pxc, pxmc, xcrop, xbox, acc, wo))
    valid = valid_y[None, :, :, None] & valid_x[None, :, None, :]
    return torch.where(valid, out, 0)


def sample_rect_direct(
    frame: torch.Tensor,
    grid: LogRectGrid,
    center: torch.Tensor,
    *,
    wrap_x: bool = True,
    in_layout: str = "chw",
    out_layout: str = "hwc",
) -> torch.Tensor:
    """Foveate a uint8 frame directly (no SAT): bit-identical to
    ``sample_rect_from_sat(build_sat(frame), grid, center)`` for centres in
    [0, 1]^2.

    ``frame``: (3, Hs, Ws) uint8 (``in_layout="chw"``) or (Hs, Ws, 3)
    (``"hwc"``).  ``center``: float32 (2,) tensor.  Returns (Ho, Wo, 3)
    for ``out_layout="hwc"``, (3, Ho, Wo) for ``"chw"``.  See the module
    docstring for the algorithm.
    """
    if in_layout == "hwc":
        frame = frame.permute(2, 0, 1)
    out = _sample_direct(frame, grid, center.reshape(1, 2), wrap_x)[:, 0]
    return out if out_layout == "chw" else out.permute(1, 2, 0).contiguous()


def sample_rect_direct_batch(
    frame: torch.Tensor,
    grid: LogRectGrid,
    centers: torch.Tensor,
    *,
    wrap_x: bool = True,
    in_layout: str = "chw",
    out_layout: str = "hwc",
) -> torch.Tensor:
    """N gazes against one shared frame, no SAT: the row prefix sums are
    taken once for the batch.  ``centers``: (N, 2) float32.  Returns (N,
    Hr, Wr, 3) for ``out_layout="hwc"`` (the serve tick's encode layout),
    (N, 3, Hr, Wr) for ``"chw"``."""
    if in_layout == "hwc":
        frame = frame.permute(2, 0, 1)
    out = _sample_direct(frame, grid, centers, wrap_x)
    order = (1, 0, 2, 3) if out_layout == "chw" else (1, 2, 3, 0)
    return out.permute(order).contiguous()
