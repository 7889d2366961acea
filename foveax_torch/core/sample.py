"""Gaze-centred log-rectilinear box-filter taps (counterpart of
``foveax/core/sample.py``).

Because the grid is separable, every tap coordinate is a 1-D vector:
``pc``/``pmc`` over output columns (x axis) or rows (y axis).  The box of
output cell (j, i) is the source interval ``(pmc, pc]`` on each axis
(reference: src/sat_decoder_sample_rect_kernel.cl:138-241).  The gaze
enters as a runtime tensor added to the grid, so a moving gaze rebuilds
nothing.

:func:`sample_rect_from_sat` is the SAT path's 4-tap sampler: the taps
here, the box means in K7 (``kernels/sat_sample.py``), which reads four
SAT words per output value.  The JAX package's shared-tap gathers
(``q``/``fix`` of its ``_axis_taps``, the ``top_k`` fixup and the uint16
row bands) halve the traffic through the TPU's slow gather engine; the
port reaches the same integers without them, so those outputs are not
carried over.

The CLI-only samplers follow: :func:`sample_rect_360_from_sat` (the
reference's second SAT kernel, with its own 360 indexing),
:func:`expand_sampled_rect` (where the samples land) and
:func:`sample_rect_point` (the aliasing point-sample baseline).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from foveax_torch.core.logrect import LogRectGrid, delta64, scaled_center
from foveax_torch.kernels.sat_sample import _exact_box_div, sat_sample_batch
from foveax_torch.kernels.scan2d import MASK32
from foveax_torch.pipeline import profiling


def longest_run(mask) -> tuple[int, int]:
    """[start, end) of the longest contiguous True run in a bool array
    (the first of equal length); (0, 0) when none is True.  The direct
    sampler's band split (:mod:`foveax_torch.core.direct`) uses it."""
    best = (0, 0)
    start = None
    n = len(mask)
    for j in range(n + 1):
        if j < n and mask[j]:
            if start is None:
                start = j
        else:
            if start is not None and j - start > best[1] - best[0]:
                best = (start, j)
            start = None
    return best


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


def gaze_taps(grid: LogRectGrid, hs: int, ws: int, centers: torch.Tensor, *,
              wrap_x: bool = True):
    """Per-gaze taps of an Hs x Ws source for (N, 2) float32 centres:
    ``(pxc, pxmc, valid_x)``, each (N, Wr), then ``(pyc, pymc,
    valid_y)``, each (N, Hr); ``wrap_x`` wraps the column axis.  A
    ``sampler.taps`` span: every sampler reaches it."""
    with profiling.span("sampler.taps", viewers=centers.shape[0]):
        cx, cy = scaled_center(centers, ws, hs)  # (N,)
        pxc, pxmc, valid_x = _axis_taps(grid.gx, cx[:, None], ws, wrap=wrap_x)
        pyc, pymc, valid_y = _axis_taps(grid.gy, cy[:, None], hs, wrap=False)
        return pxc, pxmc, valid_x, pyc, pymc, valid_y


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
    schemes; both give these integers, which K7
    (:func:`~foveax_torch.kernels.sat_sample.sat_sample_batch`) computes
    from the per-axis taps: four SAT words per output value, the 4-tap
    difference mod 2^32 and the exact box division (on a CPU SAT its
    plain version), in a ``sampler.kernel`` span that carries the gaze
    count as ``viewers``.
    """
    if taps not in ("shared", "paired"):
        raise ValueError(f"taps {taps!r}: expected 'shared' or 'paired'")
    _, hs, ws = sat.shape
    pxc, pxmc, valid_x, pyc, pymc, valid_y = gaze_taps(
        grid, hs, ws, center.reshape(-1, 2), wrap_x=wrap_x
    )
    with profiling.span("sampler.kernel", kernel="K7", viewers=pxc.shape[0]):
        out = sat_sample_batch(
            sat, pxmc, pxc, valid_x, pymc, pyc, valid_y, out_layout
        )
    return out if center.dim() == 2 else out[0]


@functools.lru_cache(maxsize=8)
def _flat_pair_maps(wo: int, ho: int, device: torch.device):
    """The 360 kernel's flat short2 pair indices, which depend only on the
    shape: (x, y) grid-vector indices of the hi and lo pair of every
    output texel, (Ho, Wo) int64 each, and the ``defined`` mask."""
    gw, gh = wo + 1, ho + 1
    jj, ii = np.mgrid[0:ho, 0:wo]
    flat_hi = (jj + 2) * gw + (ii + 2)
    flat_lo = (jj + 2) * gw + (ii - 1)
    defined = flat_hi < gh * gw
    fh = np.clip(flat_hi, 0, gh * gw - 1)
    fl = np.clip(flat_lo, 0, gh * gw - 1)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (fh % gw, fh // gw, fl % gw, fl // gw, defined)
    )


def sample_rect_360_from_sat(
    sat: torch.Tensor,
    grid: LogRectGrid,
    center: torch.Tensor,
    *,
    out_layout: str = "hwc",
) -> torch.Tensor:
    """The reference's second sampling kernel, ``sample_rect_360_kernel``
    (reference: src/sat_decoder_sample_rect_kernel.cl:298-382), with its
    own grid indexing.

    Deltas are read as flat short2 pairs at ``(j+2)*gw + (i+2)`` and
    ``(j+2)*gw + (i-1)``, so (a) the x-box spans 3 grid cells, (b) both
    edges take their y-delta from grid row j+2 (one source row tall after
    the clamp), and (c) at the first and last output column the flat index
    rolls into the adjacent grid row.  The reference reads past the grid
    buffer where ``(j+2)*gw + (i+2) >= gh*gw``; those texels are 0 here, as
    in the JAX package (the image is defined only where the golden's
    ``defined`` mask holds).  Not a hot path: dense 2-D index maps, the
    4-tap difference in int64 mod 2^32 and the exact box division.
    """
    _, hs, ws = sat.shape
    cx, cy = scaled_center(center, ws, hs)
    # The grid vectors and the gaze stay device tensors.
    hi_x, hi_y, lo_x, lo_y, defined = _flat_pair_maps(
        grid.out_width, grid.out_height, sat.device
    )
    gx = grid.gx.to(torch.int32)
    gy = grid.gy.to(torch.int32)
    px = cx + gx[hi_x]
    py = cy + gy[hi_y]
    pxm = cx + gx[lo_x]
    pym = cy + gy[lo_y]

    # Shared tail of both kernels: wrap, validity, clamp, 4-tap box.
    wrap_hi = (px >= ws) & (pxm >= ws)
    wrap_lo = (px < 0) & (pxm < 0)
    shift = torch.where(wrap_hi, -ws, torch.where(wrap_lo, ws, 0))
    px = px + shift
    pxm = pxm + shift

    valid = (((px >= 0) & (px < ws)) | ((pxm >= 0) & (pxm < ws))) & (
        ((py >= 0) & (py < hs)) | ((pym >= 0) & (pym < hs))
    )
    pxc = px.clamp(1, ws - 1).long()
    pyc = py.clamp(1, hs - 1).long()
    pxmc = torch.minimum(pxm.clamp_min(0).long(), pxc - 1)
    pymc = torch.minimum(pym.clamp_min(0).long(), pyc - 1)

    s = sat.view(torch.int32)

    def at(y, x):  # (3, Ho, Wo), the uint32 values mod 2^32
        return s[:, y, x].to(torch.int64) & MASK32

    box = (at(pyc, pxc) - at(pymc, pxc) + at(pymc, pxmc) - at(pyc, pxmc)) & MASK32
    rect = (pyc - pymc) * (pxc - pxmc)
    vals = _exact_box_div(box, rect[None])
    keep = (valid & defined)[None]
    out = torch.where(keep, vals, 0).to(torch.uint8)
    return out if out_layout == "chw" else out.permute(1, 2, 0).contiguous()


def expand_sampled_rect(
    reduced: torch.Tensor,
    out_width: int,
    out_height: int,
    center: torch.Tensor,
) -> torch.Tensor:
    """Forward-scatter expansion: place each reduced texel at its full-res
    anchor position, leaving gaps black — the reference's debugging
    visualization of where samples land (reference:
    src/sat_decoder.cc:555-616 ExpandSampledFrameRectCPU).

    (Hr, Wr, 3) uint8 -> (out_height, out_width, 3) uint8.  The raw deltas
    are strictly increasing per axis (the delta curve is convex through 0,
    so once it leaves |u| its step exceeds 1), so no two texels land on
    one pixel and the scatter has one writer per pixel on any device.
    """
    hr, wr, _ = reduced.shape
    # Raw (non-averaged) deltas with lambda from the OUTPUT dims, exactly
    # as the reference helper computes them.
    dx = delta64(np.arange(wr) - wr // 2, wr, out_width)
    dy = delta64(np.arange(hr) - hr // 2, hr, out_height)
    dev = reduced.device
    cx, cy = scaled_center(center, out_width, out_height)
    x = cx + torch.from_numpy(dx.astype(np.int32)).to(dev)  # (Wr,)
    y = cy + torch.from_numpy(dy.astype(np.int32)).to(dev)  # (Hr,)
    valid = ((x >= 0) & (x < out_width))[None, :] & (
        (y >= 0) & (y < out_height)
    )[:, None]
    flat = (y[:, None] * out_width + x[None, :]).long()

    out = torch.zeros((out_height * out_width, 3), dtype=torch.uint8, device=dev)
    out[flat[valid]] = reduced[valid]
    return out.reshape(out_height, out_width, 3)


def sample_rect_point(
    frame: torch.Tensor,
    grid: LogRectGrid,
    center: torch.Tensor,
) -> torch.Tensor:
    """Aliasing baseline: point-sample the RGB frame directly through the
    raw-delta grid — no SAT, no averaging (reference:
    src/image_sampler_sample_rect_kernel.cl:1-46, host
    src/image_sampler.cc:249-299).  Takes a (H, W, 3) uint8 frame and a
    :func:`~foveax_torch.core.logrect.make_point_grid` grid; returns
    (Ho, Wo, 3) uint8.
    """
    hs, ws, _ = frame.shape
    cx, cy = scaled_center(center, ws, hs)
    x = cx + grid.gx.to(torch.int32)  # (Wo,)
    y = cy + grid.gy.to(torch.int32)  # (Ho,)

    # Single-sided x wrap (reference kernel :29-33), y bounds check.
    x = torch.where(x >= ws, x - ws, torch.where(x < 0, x + ws, x))
    valid = ((x >= 0) & (x < ws))[None, :] & ((y >= 0) & (y < hs))[:, None]
    xc = x.clamp(0, ws - 1)
    yc = y.clamp(0, hs - 1)

    vals = frame.index_select(0, yc).index_select(1, xc)
    return torch.where(valid[..., None], vals, 0).to(torch.uint8)
