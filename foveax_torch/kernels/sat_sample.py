"""The SAT path's 4-tap sampler: K7, a hand-written CUDA kernel
(``csrc/sat_sample.cu``), with its plain PyTorch twin.

:func:`sat_sample_batch`: a (3, Hs, Ws) ``torch.uint32`` SAT + per-gaze
column taps (N, Wr) and row taps (N, Hr) -> (N, 3, Hr, Wr) ("chw") or (N,
Hr, Wr, 3) ("hwc") uint8, the box mean ``floor(box / (dy*dx))`` with ``box
= (S[pyc, pxc] - S[pymc, pxc] - S[pyc, pxmc] + S[pymc, pxmc]) mod 2^32``,
0 where the cell's row or column is invalid.  The taps are the ones
``kernels/segreduce.py::fused_taps`` makes, so the signature mirrors
``segment_reduce_xy_batch`` with the SAT in place of the frame.

It has no Pallas counterpart: foveax computes the same function in plain
JAX (``foveax/core/sample.py:155 sample_rect_from_sat``).  The plain
version here gathers whole SAT rows and then columns, about 23 GB a gaze
at 36000x18000 -> 20000x10000; the kernel reads four SAT words per output
value and holds nothing else.  A wrapper runs the plain version for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from foveax_torch.kernels.build import I, P, Kernel, check_tensor
from foveax_torch.kernels.scan2d import MASK32

SAT_SAMPLE = Kernel("sat_sample", "fvx_sat_sample", [P] * 8 + [I] * 6)

LAYOUTS = ("chw", "hwc")


def _exact_box_div(box: torch.Tensor, rect: torch.Tensor) -> torch.Tensor:
    """Exact ``floor(box / rect)`` for non-negative integer boxes and
    positive rects (what the JAX package's float estimate plus one-step
    fixup computes); integer floor division is exact as it stands."""
    return torch.div(box, rect, rounding_mode="floor")


def sat_sample_batch_plain(
    sat: torch.Tensor,
    pxmc: torch.Tensor,
    pxc: torch.Tensor,
    valid_x: torch.Tensor,
    pymc: torch.Tensor,
    pyc: torch.Tensor,
    valid_y: torch.Tensor,
    out_layout: str = "hwc",
) -> torch.Tensor:
    """Plain K7: two row gathers and four column gathers on the SAT's
    int32 view, the 4-tap difference in int64 mod 2^32 and the exact box
    division."""
    _, _, ws = sat.shape
    n, wo = pxc.shape
    ho = pyc.shape[1]
    s = sat.view(torch.int32)

    def rows(idx):  # (3, N, Ho, Ws) int32
        return s.index_select(1, idx.reshape(-1)).reshape(3, n, ho, ws)

    def cols(r, idx):  # (3, N, Ho, Wo), the uint32 values mod 2^32
        idx = idx.long()[None, :, None, :].expand(3, n, ho, wo)
        return r.gather(3, idx).to(torch.int64)

    hi, lo = rows(pyc), rows(pymc)
    box = (
        cols(hi, pxc) - cols(lo, pxc) - cols(hi, pxmc) + cols(lo, pxmc)
    ) & MASK32  # a true box sum is below 2^32
    dy = (pyc - pymc).long()[None, :, :, None]
    rect = dy * (pxc - pxmc).long()[None, :, None, :]
    vals = _exact_box_div(box, rect)
    valid = valid_y[None, :, :, None] & valid_x[None, :, None, :]
    out = torch.where(valid, vals, 0).to(torch.uint8)
    order = (1, 0, 2, 3) if out_layout == "chw" else (1, 2, 3, 0)
    return out.permute(order).contiguous()


def check_sat_sample(
    sat: torch.Tensor,
    pxmc: torch.Tensor,
    pxc: torch.Tensor,
    valid_x: torch.Tensor,
    pymc: torch.Tensor,
    pyc: torch.Tensor,
    valid_y: torch.Tensor,
    out_layout: str,
) -> tuple[int, int, int, int, int]:
    """Raise ValueError unless the arguments are what K7 takes: a
    contiguous (3, Hs, Ws) uint32 SAT with Hs * Ws < 2^32 (so that dy * dx
    fits uint32), int32 taps and bool masks of one gaze count, all on the
    SAT's device, and a known layout.  Returns (N, Hs, Ws, Hr, Wr)."""
    if out_layout not in LAYOUTS:
        raise ValueError(f"out_layout {out_layout!r}: expected 'chw' or 'hwc'")
    if sat.dim() != 3 or sat.shape[0] != 3:
        raise ValueError(f"sat: expected (3, Hs, Ws), got {tuple(sat.shape)}")
    _, hs, ws = sat.shape
    if hs * ws >= 2**32:
        raise ValueError(
            f"sat: {ws}x{hs} has 2^32 cells or more, so a box's dy * dx "
            "could pass uint32"
        )
    for name, t in (("pxc", pxc), ("pyc", pyc)):
        if t.dim() != 2:
            raise ValueError(f"{name}: expected (N, M), got {tuple(t.shape)}")
    n, wr = pxc.shape
    hr = pyc.shape[1]
    dev = sat.device
    check_tensor(sat, "sat", torch.uint32, (3, hs, ws), dev)
    for name, t in (("pxc", pxc), ("pxmc", pxmc)):
        check_tensor(t, name, torch.int32, (n, wr), dev)
    for name, t in (("pyc", pyc), ("pymc", pymc)):
        check_tensor(t, name, torch.int32, (n, hr), dev)
    check_tensor(valid_x, "valid_x", torch.bool, (n, wr), dev)
    check_tensor(valid_y, "valid_y", torch.bool, (n, hr), dev)
    return n, hs, ws, hr, wr


def sat_sample_batch(
    sat: torch.Tensor,
    pxmc: torch.Tensor,
    pxc: torch.Tensor,
    valid_x: torch.Tensor,
    pymc: torch.Tensor,
    pyc: torch.Tensor,
    valid_y: torch.Tensor,
    out_layout: str = "hwc",
) -> torch.Tensor:
    """(3, Hs, Ws) uint32 SAT + column taps (N, Wr) + row taps (N, Hr) ->
    (N, 3, Hr, Wr) for "chw" or (N, Hr, Wr, 3) for "hwc" uint8, in one
    launch: the box mean over ``(pxmc, pxc]`` x ``(pymc, pyc]``, 0 where
    the cell's row or column is invalid.  The taps obey the clamp rule
    ``1 <= pc <= dim-1``, ``0 <= pmc < pc`` on each axis
    (``core/sample.py::_axis_taps``)."""
    if sat.device.type == "cpu":
        return sat_sample_batch_plain(
            sat, pxmc, pxc, valid_x, pymc, pyc, valid_y, out_layout
        )
    n, hs, ws, hr, wr = check_sat_sample(
        sat, pxmc, pxc, valid_x, pymc, pyc, valid_y, out_layout
    )
    shape = (n, 3, hr, wr) if out_layout == "chw" else (n, hr, wr, 3)
    out = torch.empty(shape, dtype=torch.uint8, device=sat.device)
    if out.numel():
        with torch.cuda.device(sat.device):
            SAT_SAMPLE.launch(
                sat.data_ptr(), pxc.data_ptr(), pxmc.data_ptr(),
                valid_x.data_ptr(), pyc.data_ptr(), pymc.data_ptr(),
                valid_y.data_ptr(), out.data_ptr(), n, hs, ws, hr, wr,
                int(out_layout == "hwc"),
            )
    return out
