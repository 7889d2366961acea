"""K5, ``fvx_sat_build`` (kernels/csrc/scan2d.cu), one SAT build of the
cell's frame: the least bytes and operations the build needs.

Bytes, each read once and written once: the (H, W, 3) uint8 frame and the
(3, H, W) uint32 SAT, ``3 H W + 12 H W``; 497,664,000 at 7680x4320, so
0.1486 ms at 3.35 TB/s.  Operations: two adds a value (one along the row,
one down the column).  Bytes bound it by far.  One build is three kernels
(``band_totals_kernel``, ``band_carry_kernel``, ``sat_band_kernel``), so
its time is read per build (``metrics/k5_roofline.py``), not per kernel
name."""


def cost(cell):
    h, w = cell["source_height"], cell["source_width"]
    nbytes = 3 * h * w + 12 * h * w
    ops = 2 * 3 * h * w
    return nbytes, ops
