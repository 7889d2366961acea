"""SVD-compressed summed-area tables (counterpart of
``foveax/core/svd_sat.py``).

A SAT is factored per channel as U diag(S) V (rank ~30) plus an 8-bit
quantized residual; a client can then reconstruct SAT values at the
gaze-aligned grid nodes instead of holding the full uint32 table
(reference: src/sat_decoder_sample_rect_kernel.cl:1-136 device side,
src/sat_decoder.cc:774-885 host side, src/eigen_sat_generate.cc CPU
benchmark).

The factorization runs on the host in NumPy float64, call for call as the
JAX package runs it, so that the factors and the residual are bit-equal to
its own for the same SAT.  The rank contraction is an ordered float32 sum
over the rank in elementwise ops: IEEE elementwise ops give the same bits
on the CPU and on the card, and no matrix unit rounds the operands (a
float32 ``matmul`` on the card may run in TF32, about 1e5 absolute at the
SAT magnitudes of a 1080p frame, which would swamp every box difference).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from foveax_torch.core.logrect import LogRectGrid, scaled_center


@dataclasses.dataclass(frozen=True)
class SVDSat:
    """Per-channel rank-r factorization + quantized residual of a SAT.

    u: (3, H, r) float32;  s: (3, r) float32;  v: (3, r, W) float32;
    residual_q: (H, W, 3) uint8;  ranges: (3,) float32 — residual span per
    channel (value = q * range/255 - range/2).
    """

    u: torch.Tensor
    s: torch.Tensor
    v: torch.Tensor
    residual_q: torch.Tensor
    ranges: torch.Tensor


def sat_to_numpy(sat: torch.Tensor) -> np.ndarray:
    """(3, H, W) ``torch.uint32`` SAT on any device -> host uint32 array."""
    return sat.view(torch.int32).cpu().numpy().view(np.uint32)


def compress_sat(
    sat: torch.Tensor, rank: int, *, device: str | torch.device | None = None
) -> SVDSat:
    """Factor a (3, H, W) uint32 SAT into rank-``rank`` SVD + 8-bit
    residual, on the host in float64 (``np.linalg.svd``).  The factors go
    to ``device``, the SAT's own unless given: the server passes ``"cpu"``,
    since it packs them for the wire on the host."""
    sat_np = sat_to_numpy(sat).astype(np.float64)
    us, ss, vs, res_q, ranges = [], [], [], [], []
    for c in range(3):
        u, s, vt = np.linalg.svd(sat_np[c], full_matrices=False)
        u, s, vt = u[:, :rank], s[:rank], vt[:rank]
        approx = (u * s) @ vt
        resid = sat_np[c] - approx
        rng = 2.0 * max(np.abs(resid).max(), 1e-6)
        q = np.clip((resid + rng / 2.0) * (255.0 / rng), 0, 255).astype(np.uint8)
        us.append(u.astype(np.float32))
        ss.append(s.astype(np.float32))
        vs.append(vt.astype(np.float32))
        res_q.append(q)
        ranges.append(rng)
    dev = sat.device if device is None else torch.device(device)
    return svd_sat_from_numpy(
        np.stack(us),
        np.stack(ss),
        np.stack(vs),
        np.stack(res_q, axis=-1),
        np.asarray(ranges, dtype=np.float32),
        dev,
    )


def svd_sat_from_numpy(u, s, v, residual_q, ranges, device) -> SVDSat:
    """Host factor arrays (e.g. the JAX package's ``np.asarray(svd.u)``
    and so on) -> an :class:`SVDSat` on ``device``; the arrays are copied
    and cast to the wire's float32 / uint8."""

    def put(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)

    return SVDSat(
        u=put(u, np.float32),
        s=put(s, np.float32),
        v=put(v, np.float32),
        residual_q=put(residual_q, np.uint8),
        ranges=put(ranges, np.float32),
    )


def _contract(u: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sum_k (u[c, y, k] * s[c, k]) * v[c, k, x] in float32, k in order, one
    elementwise pass per rank: (3, Y, r), (3, r), (3, r, X) -> (3, Y, X)."""
    acc = torch.zeros(
        (u.shape[0], u.shape[1], v.shape[2]), dtype=torch.float32, device=u.device
    )
    for k in range(u.shape[2]):
        acc += (u[:, :, k] * s[:, k, None])[:, :, None] * v[:, None, k, :]
    return acc


def _residual(res_q: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 residual codes -> (3, ...) float32 residual values."""
    q = res_q.to(torch.float32).movedim(-1, 0)
    shape = (3,) + (1,) * (q.dim() - 1)
    return q * (ranges / 255.0).reshape(shape) - (ranges / 2.0).reshape(shape)


def reconstruct_sat(svd: SVDSat) -> torch.Tensor:
    """Full (3, H, W) float32 SAT reconstruction (the eigen_sat_generate
    path, reference: src/eigen_sat_generate.cc:34-52)."""
    approx = _contract(svd.u, svd.s, svd.v)
    return torch.clamp_min(approx + _residual(svd.residual_q, svd.ranges), 0.0)


def create_reduced_sat(
    svd: SVDSat, grid: LogRectGrid, center: torch.Tensor
) -> torch.Tensor:
    """Gaze-aligned reduced SAT: (H_out+1, W_out+1, 5) float32 texels of
    (r, g, b, src_x, src_y).

    Mirrors create_reduced_sat_kernel (reference:
    src/sat_decoder_sample_rect_kernel.cl:79-136): per grid node, validity
    requires this-or-previous node in frame per axis; positions clamp into
    the frame.  The full (H_out+1) x (W_out+1) node lattice is filled (the
    reference's launch guard leaves its last row and column unwritten), as
    the JAX package fills it.  ``center`` is a float32 (2,) tensor on the
    factors' device.
    """
    hs, ws = svd.u.shape[1], svd.v.shape[2]
    cx, cy = scaled_center(center, ws, hs)
    px = cx + grid.gx.to(torch.int32)  # (Wo+1,)
    py = cy + grid.gy.to(torch.int32)  # (Ho+1,)
    pxm = torch.cat([px[:1], px[:-1]])  # previous node (clamped at 0)
    pym = torch.cat([py[:1], py[:-1]])
    valid_x = ((px >= 0) & (px < ws)) | ((pxm >= 0) & (pxm < ws))
    valid_y = ((py >= 0) & (py < hs)) | ((pym >= 0) & (pym < hs))
    xc = px.clamp(0, ws - 1)
    yc = py.clamp(0, hs - 1)

    approx = _contract(
        svd.u.index_select(1, yc), svd.s, svd.v.index_select(2, xc)
    )  # (3, Ho+1, Wo+1)
    res_q = svd.residual_q.index_select(0, yc).index_select(1, xc)
    rgb = torch.clamp_min(approx + _residual(res_q, svd.ranges), 0.0)
    rgb = rgb.permute(1, 2, 0)

    valid = (valid_y[:, None] & valid_x[None, :])[..., None]
    rgb = torch.where(valid, rgb, 0.0)
    pos = torch.stack(
        [
            xc[None, :].expand(rgb.shape[:2]).to(torch.float32),
            yc[:, None].expand(rgb.shape[:2]).to(torch.float32),
        ],
        dim=-1,
    )
    pos = torch.where(valid, pos, 0.0)
    return torch.cat([rgb, pos], dim=-1)


def sample_from_reduced_sat(reduced_sat: torch.Tensor) -> torch.Tensor:
    """Box-filter from a reduced SAT: (Ho+1, Wo+1, 5) -> (Ho, Wo, 3) uint8.

    Mirrors sample_rect_from_reduced_sat_kernel (reference:
    src/sat_decoder_sample_rect_kernel.cl:25-76) including its corner
    masking by rect_x/rect_y positivity and the max(rect, 1) divisor.  The
    masks are 0 or 1, so every product is exact.
    """
    tl = reduced_sat[:-1, :-1]
    tr = reduced_sat[:-1, 1:]
    bl = reduced_sat[1:, :-1]
    br = reduced_sat[1:, 1:]

    rect_x = (br[..., 3] - bl[..., 3]).to(torch.int32)
    rect_y = (br[..., 4] - tr[..., 4]).to(torch.int32)
    mx = (rect_x > 0).to(torch.float32)[..., None]
    my = (rect_y > 0).to(torch.float32)[..., None]
    mxy = ((rect_x > 0) & (rect_y > 0)).to(torch.float32)[..., None]
    mor = ((rect_x > 0) | (rect_y > 0)).to(torch.float32)[..., None]

    size = (rect_x.clamp_min(1) * rect_y.clamp_min(1)).to(torch.float32)
    val = (
        br[..., :3] * mor - tr[..., :3] * my + tl[..., :3] * mx - bl[..., :3] * mxy
    ) / size[..., None]
    return val.clamp(0.0, 255.0).to(torch.uint8)
