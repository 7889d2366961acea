"""Log-rectilinear forward map: per-axis pixel deltas and the precomputed
sampling grid (counterpart of ``foveax/core/logrect.py``).

The transform is separable: the horizontal delta depends only on the
output column and the vertical delta only on the output row (reference:
src/sat_decoder_sample_rect_kernel.cl:243-295).  The grid is therefore two
1-D vectors, ``gx`` of shape (W_out+1,) and ``gy`` of shape (H_out+1,):

    lam        = source_dim / (e - 1)
    delta(u)   = sign(u) * max(|u|, trunc(lam * (exp((2|u|/out_dim)^4) - 1)))
    grid[k]    = floor((delta(k-1-out_dim/2) + delta(k-out_dim/2)) / 2)

The math runs once per shape on the host in float64 (the authoritative
grid math of the JAX package); the device holds the results as int16
tensors.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from foveax_torch.device import resolve_device

# float32 value of exp(1.0f) - 1, as the OpenCL kernels compute it
# (reference: src/sat_decoder_sample_rect_kernel.cl:156-157).
_E_MINUS_1_F32 = np.float32(np.exp(np.float32(1.0))) - np.float32(1.0)


def lam(source_dim: int) -> np.float32:
    """Per-axis scale factor ``lambda = source_dim / (e - 1)`` in float32."""
    return np.float32(source_dim) / _E_MINUS_1_F32


def delta64(u: np.ndarray, out_dim: int, source_dim: int) -> np.ndarray:
    """float64 host-side delta — the authoritative grid math (float32
    ``exp`` can be ulps off exactly where the true value lands on an
    integer, which would flip the truncation)."""
    u = np.asarray(u, dtype=np.int64)
    au = np.abs(u).astype(np.float64)
    mag_f = (float(source_dim) / (np.e - 1.0)) * (
        np.exp((2.0 * au / out_dim) ** 4) - 1.0
    )
    mag = np.maximum(np.abs(u), np.trunc(mag_f).astype(np.int64))
    return mag * np.sign(u)


def delta_table(u_min: int, u_max: int, out_dim: int, source_dim: int) -> np.ndarray:
    """Inclusive LUT of delta values for u in [u_min, u_max], int32."""
    return delta64(
        np.arange(u_min, u_max + 1), out_dim, source_dim
    ).astype(np.int32)


def _grid_axis(out_dim: int, source_dim: int) -> np.ndarray:
    """1-D averaged grid vector of shape (out_dim + 1,), int16 (host)."""
    # Grid entry k covers thread index k; texel offset u = (k-1) - out_dim//2.
    k = np.arange(out_dim + 1, dtype=np.int64)
    u = k - 1 - out_dim // 2
    d0 = delta64(u, out_dim, source_dim)
    d1 = delta64(u + 1, out_dim, source_dim)
    return np.floor((d0 + d1) / 2.0).astype(np.int16)


def _point_grid_axis(out_dim: int, source_dim: int) -> np.ndarray:
    """1-D raw (non-averaged) grid vector of shape (out_dim,), int16.

    The ImageSampler baseline stores raw deltas without neighbour averaging
    (reference: src/image_sampler_sample_rect_kernel.cl:48-88).
    """
    i = np.arange(out_dim, dtype=np.int64)
    u = i - out_dim // 2
    return delta64(u, out_dim, source_dim).astype(np.int16)


def scaled_center(center: torch.Tensor, width: int, height: int):
    """``trunc(float32(c) * float32(dim))`` per axis, as int32 tensors
    on the centre's device: the product of a float32 tensor and an
    integer scalar is taken in float32 (dims < 2^24 are exact there), not
    in Python float64, and no host data is copied to the device."""
    c = center.to(torch.float32)
    return (c[..., 0] * width).to(torch.int32), (c[..., 1] * height).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class LogRectGrid:
    """Precomputed separable sampling grid on one device.

    ``gx``: (out_width + 1,) int16 — averaged x-deltas.
    ``gy``: (out_height + 1,) int16 — averaged y-deltas.
    (A point grid, :func:`make_point_grid`, holds raw deltas of shapes
    (out_width,) and (out_height,).)
    ``max_dy``: the largest row step of ``gy``, kept on the host so that
    the sampler can check its 16-bit row-sum bound without a device read.
    ``gx_host``/``gy_host``: the vectors' int64 bytes, kept on the host so
    that the direct sampler splits its bands without a device read.
    """

    gx: torch.Tensor
    gy: torch.Tensor
    out_width: int
    out_height: int
    source_width: int
    source_height: int
    max_dy: int
    gx_host: bytes
    gy_host: bytes

    @property
    def device(self) -> torch.device:
        return self.gx.device

    def dense(self) -> np.ndarray:
        """(len(gy), len(gx), 2) int16 dense grid, the reference's grid
        buffer layout (the JAX package's ``LogRectGrid.dense``), built
        from the host copies: no device read."""
        gx = np.frombuffer(self.gx_host, dtype=np.int64).astype(np.int16)
        gy = np.frombuffer(self.gy_host, dtype=np.int64).astype(np.int16)
        out = np.empty((gy.shape[0], gx.shape[0], 2), dtype=np.int16)
        out[..., 0] = gx[None, :]
        out[..., 1] = gy[:, None]
        return out


def grid_from_numpy(
    gx: np.ndarray,
    gy: np.ndarray,
    out_width: int,
    out_height: int,
    source_width: int,
    source_height: int,
    device: str | torch.device | None = None,
) -> LogRectGrid:
    """Host grid vectors (int16, shapes (out_width+1,) and (out_height+1,),
    e.g. the JAX package's ``np.asarray(grid.gx)``/``np.asarray(grid.gy)``)
    -> a :class:`LogRectGrid` on ``device`` (``cuda`` unless told
    otherwise)."""
    dev = resolve_device(device)
    gx = np.asarray(gx)
    gy = np.asarray(gy)
    if gx.shape != (out_width + 1,) or gy.shape != (out_height + 1,):
        raise ValueError(
            f"grid vectors {gx.shape}/{gy.shape} do not match the output "
            f"shape {out_width}x{out_height}"
        )
    return LogRectGrid(
        gx=torch.from_numpy(gx.astype(np.int16)).to(dev),
        gy=torch.from_numpy(gy.astype(np.int16)).to(dev),
        out_width=out_width,
        out_height=out_height,
        source_width=source_width,
        source_height=source_height,
        max_dy=int(np.diff(gy.astype(np.int64)).max(initial=0)),
        gx_host=gx.astype(np.int64).tobytes(),
        gy_host=gy.astype(np.int64).tobytes(),
    )


@functools.lru_cache(maxsize=32)
def _make_grid_cached(
    out_width: int, out_height: int, source_width: int, source_height: int,
    device: torch.device,
) -> LogRectGrid:
    return grid_from_numpy(
        _grid_axis(out_width, source_width),
        _grid_axis(out_height, source_height),
        out_width, out_height, source_width, source_height, device,
    )


def make_grid(
    out_width: int,
    out_height: int,
    source_width: int,
    source_height: int,
    device: str | torch.device | None = None,
) -> LogRectGrid:
    """Build (and cache per device) the averaged log-rectilinear grid."""
    return _make_grid_cached(
        out_width, out_height, source_width, source_height,
        resolve_device(device),
    )


@functools.lru_cache(maxsize=32)
def _make_point_grid_cached(
    out_width: int, out_height: int, source_width: int, source_height: int,
    device: torch.device,
) -> LogRectGrid:
    gx = _point_grid_axis(out_width, source_width)
    gy = _point_grid_axis(out_height, source_height)
    return LogRectGrid(
        gx=torch.from_numpy(gx).to(device),
        gy=torch.from_numpy(gy).to(device),
        out_width=out_width,
        out_height=out_height,
        source_width=source_width,
        source_height=source_height,
        max_dy=int(np.diff(gy.astype(np.int64)).max(initial=0)),
        gx_host=gx.astype(np.int64).tobytes(),
        gy_host=gy.astype(np.int64).tobytes(),
    )


def make_point_grid(
    out_width: int,
    out_height: int,
    source_width: int,
    source_height: int,
    device: str | torch.device | None = None,
) -> LogRectGrid:
    """Raw-delta grid of the point-sampling baseline
    (:func:`~foveax_torch.core.sample.sample_rect_point`), cached per
    device: ``gx`` (out_width,) int16, ``gy`` (out_height,) int16."""
    return _make_point_grid_cached(
        out_width, out_height, source_width, source_height,
        resolve_device(device),
    )
