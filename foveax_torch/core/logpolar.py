"""Log-polar foveation baseline, the comparison technique of the paper
(counterpart of ``foveax/core/logpolar.py``).

Forward map: output texel (i, j) — i the log-radial index, j the angular
index — samples the source at

    rho(i)   = exp(10 * (i / W_out)^alpha)
    delta    = rho(i) * (cos, sin)(2*pi*j / H_out)

point-sampled (no averaging), with x wraparound modulo the source width and
y clamping (reference: src/image_sampler_sample_logpolar_kernel.cl:5-86).
A 3x3 Gaussian (0.3377 / 0.1217 / 0.0439) is applied to the outer radial
half i >= W_out/2 only (reference kernel :88-142).

The inverse unwarp recovers (i, j) from each output pixel by radius/angle,
snaps when the forward map reproduces the pixel exactly, else blends the
four enclosing (rho, theta) cells bilinearly with angular wraparound
(reference: src/image_sampler_interpolate_kernel.cl:1-81).

The mip-pyramid variant reimplements the reference's missing kernel file
(src/image_sampler_sample_mipmap_logpolar_kernel.cl is loaded at
src/image_sampler.cc:125-148 but absent from the repo) from its host-side
calling convention (src/image_sampler.cc:859-990): a flat buffer of 2x
box-downsampled levels with an (offset, w, h) table; each radial ring
samples the level whose texel pitch matches the ring's radial step.

The delta grid and every transcendental table are float64 host
precomputes, as in the JAX package; per frame the work is index math and
gathers on the frame's device, with the gaze a device tensor.  The blur
and the unwarp compute in float32 elementwise ops (no fused multiply-add
on the CPU; the card's ``log``/``atan`` are not the CPU's, so a snap
decision may differ there).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from foveax_torch.device import resolve_device

_TWO_PI = 2.0 * np.pi


def _rho(i: np.ndarray, out_w: int, alpha: float) -> np.ndarray:
    return np.exp(10.0 * (i / float(out_w)) ** alpha)


@dataclasses.dataclass(frozen=True)
class LogPolarGrid:
    """Precomputed log-polar tables for one (out, source) shape pair on
    one device."""

    deltas: torch.Tensor  # (H_out, W_out, 2) int16 — truncated (dx, dy)
    out_width: int
    out_height: int
    source_width: int
    source_height: int
    alpha: float


def _grid_deltas(out_width: int, out_height: int, alpha: float) -> np.ndarray:
    """(H_out, W_out, 2) int16 host deltas, float64 math."""
    i = np.arange(out_width, dtype=np.float64)
    j = np.arange(out_height, dtype=np.float64)
    rho = _rho(i, out_width, alpha)  # (W,)
    ang = j / float(out_height) * _TWO_PI  # (H,)
    dx = np.trunc(rho[None, :] * np.cos(ang)[:, None]).astype(np.int16)
    dy = np.trunc(rho[None, :] * np.sin(ang)[:, None]).astype(np.int16)
    return np.stack([dx, dy], axis=-1)


def logpolar_grid_from_numpy(
    deltas: np.ndarray,
    out_width: int,
    out_height: int,
    source_width: int,
    source_height: int,
    alpha: float = 1.0,
    device: str | torch.device | None = None,
) -> LogPolarGrid:
    """Host deltas ((out_height, out_width, 2) int16, e.g. the JAX
    package's ``np.asarray(grid.deltas)``) -> a :class:`LogPolarGrid` on
    ``device`` (``cuda`` unless told otherwise)."""
    deltas = np.asarray(deltas)
    if deltas.shape != (out_height, out_width, 2):
        raise ValueError(
            f"deltas {deltas.shape} do not match the output shape "
            f"{out_width}x{out_height}"
        )
    return LogPolarGrid(
        deltas=torch.from_numpy(deltas.astype(np.int16)).to(resolve_device(device)),
        out_width=out_width,
        out_height=out_height,
        source_width=source_width,
        source_height=source_height,
        alpha=alpha,
    )


@functools.lru_cache(maxsize=16)
def _make_logpolar_grid_cached(
    out_width, out_height, source_width, source_height, alpha, device
) -> LogPolarGrid:
    return logpolar_grid_from_numpy(
        _grid_deltas(out_width, out_height, alpha),
        out_width, out_height, source_width, source_height, alpha, device,
    )


def make_logpolar_grid(
    out_width: int,
    out_height: int,
    source_width: int,
    source_height: int,
    alpha: float = 1.0,
    device: str | torch.device | None = None,
) -> LogPolarGrid:
    """Build (and cache per device) the log-polar grid."""
    return _make_logpolar_grid_cached(
        out_width, out_height, source_width, source_height, alpha,
        resolve_device(device),
    )


def _positions(grid: LogPolarGrid, center: torch.Tensor, ws: int, hs: int):
    """Source (x, y) of every output texel, int32 (H_out, W_out): float32
    add then truncation, x modulo wrap, y clamp
    (src/image_sampler_sample_logpolar_kernel.cl:67-74)."""
    d = grid.deltas.to(torch.float32)
    c = center.to(torch.float32)
    x = (c[0] * ws + d[..., 0]).to(torch.int32)
    y = (c[1] * hs + d[..., 1]).to(torch.int32)
    x = torch.remainder(x + 10 * ws, ws)
    y = y.clamp(0, hs - 1)
    return x, y


def sample_logpolar(
    frame: torch.Tensor, grid: LogPolarGrid, center: torch.Tensor
) -> torch.Tensor:
    """(Hs, Ws, 3) uint8 -> (H_out, W_out, 3) uint8 log-polar point
    sample."""
    hs, ws, _ = frame.shape
    x, y = _positions(grid, center, ws, hs)
    return frame.reshape(-1, 3)[(y * ws + x).long()]


def logpolar_gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    """3x3 Gaussian on the outer radial half (columns i >= W/2) only.

    Weights 0.3377 center / 0.1217 edge / 0.0439 corner, clamped borders
    (reference: src/image_sampler_sample_logpolar_kernel.cl:110-137).
    """
    h, w, _ = img.shape
    f = img.to(torch.float32)
    p = F.pad(f.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")[0]
    p = p.permute(1, 2, 0)  # (H+2, W+2, 3), edge-padded
    c = p[1:-1, 1:-1]
    edges = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
    corners = p[:-2, :-2] + p[:-2, 2:] + p[2:, :-2] + p[2:, 2:]
    blurred = 0.3377 * c + 0.1217 * edges + 0.0439 * corners
    cols = torch.arange(w, device=img.device) >= w // 2
    return torch.where(cols[None, :, None], blurred, f).to(torch.uint8)


@functools.lru_cache(maxsize=16)
def _forward_tables(wr: int, hr: int, alpha: float):
    """Host float32 forward deltas rho(i)*(cos, sin)(2 pi j / Hr), flat."""
    rho_t = _rho(np.arange(wr, dtype=np.float64), wr, alpha)
    ang_t = np.arange(hr, dtype=np.float64) / float(hr) * _TWO_PI
    fwd_dx = (rho_t[None, :] * np.cos(ang_t)[:, None]).astype(np.float32)
    fwd_dy = (rho_t[None, :] * np.sin(ang_t)[:, None]).astype(np.float32)
    return fwd_dx.reshape(-1), fwd_dy.reshape(-1)


def unwarp_logpolar(
    reduced: torch.Tensor,
    out_width: int,
    out_height: int,
    center: torch.Tensor,
    alpha: float = 1.0,
) -> torch.Tensor:
    """Inverse log-polar: (Hr, Wr, 3) uint8 -> (out_h, out_w, 3) uint8.

    Mirrors src/image_sampler_interpolate_kernel.cl: radius/angle
    inversion, snap-exact check against a host-precomputed forward table,
    else bilinear in (rho, theta) with angular wrap.
    """
    hr, wr, _ = reduced.shape
    dev = reduced.device
    fx, fy = _forward_tables(wr, hr, alpha)
    fwd_dx = torch.from_numpy(fx).to(dev)
    fwd_dy = torch.from_numpy(fy).to(dev)

    c = center.to(torch.float32)
    c0w = c[0] * out_width
    c1h = c[1] * out_height
    cxp = c0w.to(torch.int32)
    cyp = c1h.to(torch.int32)

    xs = torch.arange(out_width, dtype=torch.int32, device=dev)[None, :]
    ys = torch.arange(out_height, dtype=torch.int32, device=dev)[:, None]
    half = out_width // 2
    x = torch.where(
        xs - cxp > half,
        xs - out_width,
        torch.where(xs - cxp < -half, xs + out_width, xs),
    )
    dx = (x - cxp).to(torch.float32).expand(out_height, out_width)
    dy = (ys - cyp).to(torch.float32).expand(out_height, out_width)

    r2 = dx * dx + dy * dy
    at_center = (dx == 0) & (dy == 0)
    radial = torch.log(torch.sqrt(r2)) / 10.0
    if alpha != 1.0:
        radial = radial ** float(np.float32(1.0 / alpha))
    i_f = torch.where(at_center, 0.0, radial * wr)
    i_idx = torch.floor(i_f + 0.5).to(torch.int32).clamp(0, wr - 1)

    # Angle: atan with the pi*(dx<0) branch correction, wrapped to [0, Hr)
    # (reference kernel :36-43).  Python scalars enter each op as float32.
    scale = float(np.float32(hr) / np.float32(_TWO_PI))
    j_gen = (
        torch.atan(dy / torch.where(dx == 0, 1.0, dx)) + (dx < 0) * np.pi
    ) * scale
    j_gen = torch.remainder(j_gen + 2 * hr, hr)
    j_dx0 = ((dy < 0) * np.pi + np.pi / 2) * scale
    j_f = torch.where(dx == 0, j_dx0, j_gen)
    j_idx = torch.floor(j_f + 0.5).to(torch.int32).clamp(0, hr - 1)

    # Snap check: forward-map (i_idx, j_idx) and compare to the pixel.
    flat_fwd = (j_idx * wr + i_idx).long()
    calc_x = (c0w + fwd_dx[flat_fwd]).to(torch.int32)
    calc_y = (c1h + fwd_dy[flat_fwd]).to(torch.int32)
    exact = (calc_x == x) & (calc_y == ys)

    flat = reduced.to(torch.float32).reshape(-1, 3)

    min_i = torch.floor(i_f).to(torch.int32).clamp(0, wr - 1)
    max_i = torch.ceil(i_f).to(torch.int32).clamp(0, wr - 1)
    min_j = torch.remainder(torch.floor(j_f).to(torch.int32) + hr, hr)
    max_j = torch.remainder(torch.ceil(j_f).to(torch.int32) + hr, hr)

    def take(j, i):
        return flat[(j * wr + i).long()]

    tl, tr = take(min_j, min_i), take(min_j, max_i)
    bl, br = take(max_j, min_i), take(max_j, max_i)

    ir = (i_f - torch.floor(i_f))[..., None]
    jr = (j_f - torch.floor(j_f))[..., None]
    left = tl + (bl - tl) * jr
    right = tr + (br - tr) * jr
    blended = left + (right - left) * ir

    ev = take(j_idx, i_idx)
    return torch.where(exact[..., None], ev, blended).to(torch.uint8)


# ---------------------------------------------------------------------------
# Image pyramid variant


@functools.lru_cache(maxsize=16)
def pyramid_layout(width: int, height: int, levels: int):
    """(offsets, widths, heights) following the reference host loop
    (src/image_sampler.cc:881-919): offset accumulates the *previous*
    level's pixel count; dims halve by integer division."""
    offs, ws, hs = [0], [width], [height]
    off, w, h = 0, width, height
    for _ in range(1, levels):
        off += w * h
        w //= 2
        h //= 2
        offs.append(off)
        ws.append(w)
        hs.append(h)
    return tuple(offs), tuple(ws), tuple(hs)


def build_pyramid(frame: torch.Tensor, levels: int) -> torch.Tensor:
    """(H, W, 3) uint8 -> flat (N, 3) uint8 buffer of ``levels`` mip
    levels.  Level k+1 is the 2x2 box mean (truncated) of level k, as in
    the JAX package (the reference's downsample kernel is the missing
    file)."""
    h, w, _ = frame.shape
    _, ws, hs = pyramid_layout(w, h, levels)
    flat_parts = [frame.reshape(-1, 3)]
    cur = frame
    for k in range(1, levels):
        hw, ww = hs[k], ws[k]
        c = cur[: 2 * hw, : 2 * ww].to(torch.int32)
        down = (
            (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]) // 4
        ).to(torch.uint8)
        flat_parts.append(down.reshape(-1, 3))
        cur = down
    return torch.cat(flat_parts, dim=0)


@functools.lru_cache(maxsize=16)
def _ring_levels(wo: int, alpha: float, levels: int, ws: int, hs: int):
    """Per radial index i: the mip level, its offset, width and height."""
    offs, lws, lhs = pyramid_layout(ws, hs, levels)
    rho = _rho(np.arange(wo + 1, dtype=np.float64), wo, alpha)
    step = np.maximum(rho[1:] - rho[:-1], 1.0)
    lvl = np.clip(np.floor(np.log2(step)).astype(np.int64), 0, levels - 1)
    return (
        lvl.astype(np.int32),
        np.asarray(offs, np.int64)[lvl],
        np.asarray(lws, np.int32)[lvl],
        np.asarray(lhs, np.int32)[lvl],
    )


def sample_logpolar_pyramid(
    pyramid_flat: torch.Tensor,
    grid: LogPolarGrid,
    center: torch.Tensor,
    levels: int,
) -> torch.Tensor:
    """Log-polar sample with per-ring mip selection.

    Ring i samples level  clamp(floor(log2(max(rho(i+1)-rho(i), 1))), 0, L-1)
    — the level whose texel pitch matches the ring's radial step, which is
    the anti-aliasing rationale of the mip variant.
    """
    ws, hs = grid.source_width, grid.source_height
    dev = pyramid_flat.device
    lvl, lvl_off, lvl_w, lvl_h = (
        torch.from_numpy(a).to(dev)[None, :]
        for a in _ring_levels(grid.out_width, grid.alpha, levels, ws, hs)
    )
    x, y = _positions(grid, center, ws, hs)
    lx = torch.minimum(x >> lvl, lvl_w - 1)
    ly = torch.minimum(y >> lvl, lvl_h - 1)
    idx = lvl_off + ly.long() * lvl_w + lx
    return pyramid_flat[idx]
