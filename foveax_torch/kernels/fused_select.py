"""Fused SAT build + row selection (counterpart of
``foveax/kernels/fused_select.py``): K6, a hand-written CUDA kernel
(``csrc/scan2d.cu``, beside K5, whose band totals, carry and band scan it
shares), with its plain PyTorch twin.

K6, :func:`sat_select_rows` (replaces ``fused_select.py:_make_kernel``):
an (H, 3, W) uint8 frame and two row lists -> the SAT rows ``pyc[j]`` and
``pymc[j]``, each (n, 3, W) ``torch.uint32``, without writing the SAT.
The JAX package's outputs carry a zero fourth channel, padding for the
TPU's 4-row DMA tiling; here there are three.

As in the JAX package, no pipeline path calls it: it is a standalone
function.  For a CUDA tensor the row lists must be non-decreasing and in
[0, H) (the kernel finds each band's entries by binary search; the
wrapper does not check that on the device, which would cost a
synchronisation).  The kernel
scans only the bands up to ``max(pyc[-1], pymc[-1])`` that hold a listed
row, writes each listed row once and copies it to the rest of its run of
duplicates in a last launch; past ``MAX_WIDTH`` columns it scans in
column tiles as K5 does.  The plain version, which the CPU runs,
does not need the order.
"""

from __future__ import annotations

import torch

from foveax_torch.kernels.build import I, P, Kernel, check_tensor
from foveax_torch.kernels.scan2d import sat_plan, sat_scan_plain

SELECT_ROWS = Kernel("scan2d", "fvx_sat_select_rows", [P] * 5 + [I] * 6)


def sat_select_rows_plain(
    frame_rcw: torch.Tensor, pyc: torch.Tensor, pymc: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K6: the plain SAT, then two row selections on its int32
    view."""
    sat = sat_scan_plain(frame_rcw.permute(1, 0, 2)).view(torch.int32)

    def rows(idx):
        sel = sat.index_select(1, idx.long()).permute(1, 0, 2)
        return sel.contiguous().view(torch.uint32)

    return rows(pyc), rows(pymc)


def sat_select_rows(
    frame_rcw: torch.Tensor, pyc: torch.Tensor, pymc: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, 3, W) uint8 + row lists (n,) int32 -> ``(sel_hi, sel_lo)``,
    each (n, 3, W) ``torch.uint32``: the SAT rows ``pyc[j]`` and
    ``pymc[j]``, as ``sat[:, pyc].transpose(0, 1)`` would give them."""
    if frame_rcw.device.type == "cpu":
        return sat_select_rows_plain(frame_rcw, pyc, pymc)
    dev = frame_rcw.device
    if frame_rcw.dim() != 3 or frame_rcw.shape[1] != 3:
        raise ValueError(
            f"frame_rcw: expected (H, 3, W), got {tuple(frame_rcw.shape)}"
        )
    h, _, w = frame_rcw.shape
    n = pyc.shape[0]
    check_tensor(frame_rcw, "frame_rcw", torch.uint8, (h, 3, w), dev)
    check_tensor(pyc, "pyc", torch.int32, (n,), dev)
    check_tensor(pymc, "pymc", torch.int32, (n,), dev)
    sel = torch.empty((2, n, 3, w), dtype=torch.uint32, device=dev)
    if sel.numel():
        plan = sat_plan(h, w)
        totals = torch.empty(plan.scratch_words, dtype=torch.uint32, device=dev)
        with torch.cuda.device(dev):
            SELECT_ROWS.launch(
                frame_rcw.data_ptr(), pyc.data_ptr(), pymc.data_ptr(),
                sel.data_ptr(), totals.data_ptr(), h, w, n, plan.band_rows,
                plan.threads, plan.chunks_per_thread,
            )
    return sel[0], sel[1]
