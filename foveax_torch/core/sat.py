"""Summed-area table construction and round-trip decode (counterpart of
``foveax/core/sat.py``).

    SAT[c, y, x] = sum over y' <= y, x' <= x of frame[y', x', c]  (mod 2^32)

The SAT is stored as ``torch.uint32``, the JAX package's dtype and bits.
The wrap past 2^32 is deliberate: a 4-tap box-sum difference is right
mod 2^32 as long as each box sum is below 2^32, which holds for every box
of fewer than 2^32 / 255 (16.8 million) pixels.  PyTorch does little arithmetic on ``uint32``, so
every difference here is taken in int64 on the 32-bit values and masked
back to 32 bits; nothing is computed in signed 32-bit, which would wrap at
2^31 (an all-255 4096x2160 frame sums past it; 3840x2160 stays 1.5% below).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from foveax_torch.kernels.scan2d import MASK32, as_int64, sat_scan
from foveax_torch.pipeline import profiling


def build_sat(frame: torch.Tensor, *, in_layout: str = "hwc") -> torch.Tensor:
    """(H, W, 3) uint8 frame (or (3, H, W) with ``in_layout="chw"``) ->
    (3, H, W) ``torch.uint32`` inclusive SAT: the plain version on a CPU
    tensor, kernel K5 on a CUDA tensor.  A ``sampler.kernel`` span around
    the launch, with the SAT's ``bytes`` (12 H W, written once), which the
    counter ``sampler.sat_bytes`` adds up."""
    with profiling.span("sampler.kernel", kernel="K5") as sp:
        sat = sat_scan(frame, in_layout=in_layout)
        sp.attrs["bytes"] = sat.nbytes
        profiling.count("sampler.sat_bytes", sat.nbytes)
        return sat


def decode_sat(sat: torch.Tensor) -> torch.Tensor:
    """Invert a SAT back to the (H, W, 3) uint8 image: each pixel is the
    four-tap difference SAT[y, x] - SAT[y-1, x] - SAT[y, x-1] +
    SAT[y-1, x-1] mod 2^32 (zero above and left of the frame), clipped to
    [0, 255] as the JAX package clips its uint32 result."""
    p = F.pad(as_int64(sat), (1, 0, 1, 0))
    img = (p[:, 1:, 1:] - p[:, :-1, 1:] - p[:, 1:, :-1] + p[:, :-1, :-1]) & MASK32
    return img.clamp(0, 255).to(torch.uint8).permute(1, 2, 0)
