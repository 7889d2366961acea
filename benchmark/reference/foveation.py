"""Plain reference of the served path: the gaze-centred log-rectilinear
box filter (what a tick's reduced frames must hold) and its inverse, the
unwarp (what a client's restored frame must hold).

Written from the upstream kernels' semantics (AugmentariumLab/
foveated-360-video, src/sat_decoder_sample_rect_kernel.cl and
src/sat_decoder_interpolate_kernel.cl), in NumPy on the host for the
per-axis vectors and in plain PyTorch for the per-pixel work, so that it
runs on whatever device holds the inputs.  It imports nothing of the
program under test and takes nothing the program made: the grid, the taps,
the box sums, the inverse map and the blend are all worked out here again
from the shapes, the gazes and the frames.

Precision, as the configuration states it:

- the grid and the forward deltas in float64, truncated toward zero;
- the inverse map's exponent ``ceil(0.5*rd*log(|d|/lam + 1)^0.25)`` in
  float32, as the upstream kernel computes it (at 1920 columns the
  float64 value lands on the other side of an integer at |d| = 911);
- box sums exact (int64 here; the program's uint32 words are exact mod
  2^32), the box mean ``floor(sum / area)``;
- the unwarp's bilinear blend in float64 from the exact fractions
  ``num / den``, truncated.

``precision="control"`` computes the same things one step lower, the
step a faster path would be tempted to take: float32 box sums, and a
bfloat16 blend.  The benchmark's control runs it in the program's place
and has to come out as not correct.
"""

from __future__ import annotations

import numpy as np
import torch

# float32 e - 1 as the upstream kernels compute it (exp(1.0f) - 1.0f).
_E_M1_F32 = np.float32(np.exp(np.float32(1.0))) - np.float32(1.0)


def delta(u: np.ndarray, out_dim: int, source_dim: int) -> np.ndarray:
    """Signed log-rectilinear delta of offset ``u``: ``sign(u) *
    max(|u|, trunc(lam * (exp((2|u|/out_dim)^4) - 1)))``, lam =
    source_dim / (e - 1), in float64."""
    u = np.asarray(u, dtype=np.int64)
    au = np.abs(u).astype(np.float64)
    mag = (float(source_dim) / (np.e - 1.0)) * (np.exp((2.0 * au / out_dim) ** 4) - 1.0)
    return np.maximum(np.abs(u), np.trunc(mag).astype(np.int64)) * np.sign(u)


def grid_axis(out_dim: int, source_dim: int) -> np.ndarray:
    """(out_dim + 1,) averaged grid: entry k is ``floor((delta(k - 1 -
    out_dim//2) + delta(k - out_dim//2)) / 2)``."""
    u = np.arange(out_dim + 1, dtype=np.int64) - 1 - out_dim // 2
    return np.floor((delta(u, out_dim, source_dim) + delta(u + 1, out_dim, source_dim)) / 2.0).astype(np.int64)


def scaled(c: float, dim: int) -> int:
    """``(int)(c * dim)`` in float32, as the kernels scale a gaze."""
    return int(np.float32(c) * np.float32(dim))


def axis_taps(g: np.ndarray, c: int, dim: int, wrap: bool):
    """One axis of a cell's box: ``(hi, lo, valid)``, the box spanning
    source indices (lo, hi].  Wraps by a whole frame only where both edges
    fall off one side; clamps hi into [1, dim-1] and lo into [0, hi-1]."""
    p = c + g
    hi, lo = p[1:].copy(), p[:-1].copy()
    if wrap:
        shift = np.where((hi >= dim) & (lo >= dim), -dim, np.where((hi < 0) & (lo < 0), dim, 0))
        hi += shift
        lo += shift
    valid = ((hi >= 0) & (hi < dim)) | ((lo >= 0) & (lo < dim))
    hi = np.clip(hi, 1, dim - 1)
    lo = np.minimum(np.maximum(lo, 0), hi - 1)
    return hi, lo, valid


class BoxFilter:
    """The reduced frames of one (source, reduced) shape.  ``sums`` keeps
    the summed-area table of the last frame given, so that several gazes
    on one frame build it once."""

    def __init__(self, source_width: int, source_height: int, reduced_width: int,
                 reduced_height: int, *, precision: str = "exact"):
        if precision not in ("exact", "control"):
            raise ValueError(f"precision {precision!r}")
        self.ws, self.hs = source_width, source_height
        self.gx = grid_axis(reduced_width, source_width)
        self.gy = grid_axis(reduced_height, source_height)
        self.precision = precision
        self._key = None
        self._sat = None

    def _table(self, frame: torch.Tensor, key) -> torch.Tensor:
        if key is None or key != self._key:
            dtype = torch.int64 if self.precision == "exact" else torch.float32
            planes = frame.permute(2, 0, 1).to(dtype)
            self._sat = planes.cumsum(1).cumsum(2)
            self._key = key
        return self._sat

    def __call__(self, frame: torch.Tensor, gaze, key=None) -> torch.Tensor:
        """(H, W, 3) uint8 frame and one gaze (cx, cy) in [0, 1) ->
        (Hr, Wr, 3) uint8 on the frame's device.  ``key`` names the frame
        for the table cache (None: no cache)."""
        sat = self._table(frame, key)
        dev = frame.device
        xh, xl, xv = axis_taps(self.gx, scaled(gaze[0], self.ws), self.ws, True)
        yh, yl, yv = axis_taps(self.gy, scaled(gaze[1], self.hs), self.hs, False)
        t = {k: torch.from_numpy(v).to(dev) for k, v in
             (("xh", xh), ("xl", xl), ("yh", yh), ("yl", yl))}
        out = []
        for c in range(3):
            rows_h = sat[c].index_select(0, t["yh"])
            rows_l = sat[c].index_select(0, t["yl"])
            box = (rows_h.index_select(1, t["xh"]) - rows_l.index_select(1, t["xh"])
                   - rows_h.index_select(1, t["xl"]) + rows_l.index_select(1, t["xl"]))
            del rows_h, rows_l
            out.append(box)
        box = torch.stack(out, -1)
        area = torch.from_numpy(((yh - yl)[:, None] * (xh - xl)[None, :])).to(dev)
        if self.precision == "exact":
            mean = torch.div(box, area[..., None], rounding_mode="floor")
        else:
            mean = torch.floor(box / area[..., None].to(torch.float32))
        keep = torch.from_numpy(yv[:, None] & xv[None, :]).to(dev)[..., None]
        return torch.where(keep, mean.clamp(0, 255), 0).to(torch.uint8)


def _inverse_exponent(out_dim: int, reduced_dim: int, wrap: bool) -> np.ndarray:
    """``ceil(0.5*rd * log(|d|/lam + 1)^0.25)`` in float32 for every |d|
    the axis reaches: [0, out_dim], or [0, out_dim // 2] on the wrap
    axis."""
    n = out_dim // 2 if wrap else out_dim
    ad = np.arange(n + 1, dtype=np.float32)
    lam = np.float32(out_dim) / _E_M1_F32
    half = np.float32(0.5 * np.float32(reduced_dim))
    return np.ceil(half * np.log(ad / lam + np.float32(1.0)) ** np.float32(0.25)).astype(np.int64)


def unwarp_axis(out_dim: int, reduced_dim: int, c: int, wrap: bool):
    """Per-axis inverse map for output pixels 0..out_dim-1 and the scaled
    gaze ``c``: ``(exact, i_exact, i_lo, i_hi, num, den)``.  ``exact``
    marks pixels that land on a reduced texel (``i_exact``); elsewhere the
    value blends texels ``i_lo`` and ``i_hi`` by ``num / den``."""
    p = np.arange(out_dim, dtype=np.int64)
    if wrap:
        half = out_dim // 2
        shift = np.where(p - c > half, -out_dim, np.where(p - c < -half, out_dim, 0))
    else:
        shift = np.zeros_like(p)
    wrapped = shift != 0
    pw = p + shift
    d = pw - c
    sd = np.sign(d)
    u_raw = _inverse_exponent(out_dim, reduced_dim, wrap)[np.abs(d)] * sd
    u = np.where((np.abs(u_raw) > np.abs(d)) | (u_raw == 0), d, u_raw)

    def fwd(uu):  # forward delta of cell uu, signed as u
        return np.abs(delta(uu, reduced_dim, out_dim)) * np.sign(u)

    d_calc = fwd(u)
    exact = d_calc == d
    du = -sd
    d_min = fwd(u + du)
    lo = c + np.minimum(d_min, d_calc)
    hi = c + np.maximum(d_min, d_calc)
    u_lo = np.minimum(u, u + du)
    u_hi = np.maximum(u, u + du)
    inner = ~wrapped if wrap else np.ones_like(wrapped)
    u_lo = np.where((lo < 0) & inner, u_hi, u_lo)
    u_hi = np.where((hi >= out_dim) & inner, u_lo, u_hi)
    den = np.maximum(hi - lo, 1)
    num = np.where(hi == lo, 0, np.clip(pw - lo, 0, den))
    half_r = reduced_dim // 2

    def idx(v):
        return np.clip(v + half_r, 0, reduced_dim - 1)

    return exact, idx(u), idx(u_lo), idx(u_hi), num, den


class Unwarp:
    """The restored (H, W, 3) frame of one shape, computed in blocks of
    rows so that an 8K frame fits beside the program's state."""

    def __init__(self, source_width: int, source_height: int, *, precision: str = "exact",
                 block_rows: int = 512):
        if precision not in ("exact", "control"):
            raise ValueError(f"precision {precision!r}")
        self.w, self.h = source_width, source_height
        self.precision = precision
        self.block_rows = block_rows

    def __call__(self, reduced: torch.Tensor, gaze):
        """(Hr, Wr, 3) uint8 and the gaze (cx, cy) -> ``(restored,
        fovea)``: the (H, W, 3) uint8 frame and the (H, W) mask of pixels
        that land exactly on a reduced texel, on the reduced frame's
        device."""
        hr, wr, _ = reduced.shape
        dev = reduced.device
        ex, ixe, ixl, ixh, nx, dx = unwarp_axis(self.w, wr, scaled(gaze[0], self.w), True)
        ey, iye, iyl, iyh, ny, dy = unwarp_axis(self.h, hr, scaled(gaze[1], self.h), False)
        dtype = torch.float64 if self.precision == "exact" else torch.bfloat16
        src = reduced.to(dtype)

        def tt(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        ixl_t, ixh_t, ixe_t = tt(ixl), tt(ixh), tt(ixe)
        rx = tt(nx / dx).to(dtype)[None, :, None]
        ex_t = tt(ex)
        out = torch.empty((self.h, self.w, 3), dtype=torch.uint8, device=dev)
        fovea = torch.empty((self.h, self.w), dtype=torch.bool, device=dev)
        for r0 in range(0, self.h, self.block_rows):
            r1 = min(r0 + self.block_rows, self.h)
            lo_rows = src.index_select(0, tt(iyl[r0:r1]))
            hi_rows = src.index_select(0, tt(iyh[r0:r1]))
            ry = tt(ny[r0:r1] / dy[r0:r1]).to(dtype)[:, None, None]
            tl = lo_rows.index_select(1, ixl_t)
            tr = lo_rows.index_select(1, ixh_t)
            bl = hi_rows.index_select(1, ixl_t)
            br = hi_rows.index_select(1, ixh_t)
            left = tl + (bl - tl) * ry
            right = tr + (br - tr) * ry
            blend = left + (right - left) * rx
            exact = tt(ey[r0:r1])[:, None] & ex_t[None, :]
            ev = reduced.index_select(0, tt(iye[r0:r1])).index_select(1, ixe_t)
            out[r0:r1] = torch.where(exact[..., None], ev, torch.floor(blend).clamp(0, 255).to(torch.uint8))
            fovea[r0:r1] = exact
        return out, fovea
