"""K7, ``fvx_sat_sample`` (kernels/csrc/sat_sample.cu), one call over the
cell's viewers against one SAT: the least bytes and operations the call
needs.

Bytes, per viewer, each read once and written once: the (Hr, Wr, 3)
uint8 box means; the gaze's taps (``pxc``, ``pxmc`` int32 and
``valid_x`` bool, Wr each, and the same for the Hr rows); and the SAT
words the taps touch, 4 bytes for each of 3 channels at every pair of a
distinct valid row tap and a distinct valid column tap.  K7 reads four
words a value (4,183,622,784 bytes at 8K x 8), about 4x what the taps
touch.  How many distinct taps a gaze has depends on the gaze, so the
count is the fewest over ``GAZES``, counted with the plain reference's
``axis_taps``: at 7680x4320 -> 4272x2400 every integer gaze column and row
was scanned, and the fewest is the (0, 0) gaze's, 4,059 column and 1,200
row taps, so the count never exceeds what a tick reads.  At 8K x 8 that is
8 x (30,758,400 + 60,048 + 58,449,600) = 714,144,384 bytes, 0.2132 ms at
3.35 TB/s.  Operations: three adds and a divide a value.  Bytes bound it.
"""

import numpy as np

from benchmark.reference.foveation import axis_taps, grid_axis, scaled

MATCH = "sat_sample_kernel"
# Gazes (cx, cy) over which the fewest SAT words is taken: the wrap seam,
# both poles, the centre.
GAZES = ((0.0, 0.0), (0.5, 0.5), (0.999, 0.999), (0.25, 0.02), (0.75, 0.98))


def _distinct(g, c, dim, wrap):
    hi, lo, valid = axis_taps(g, c, dim, wrap)
    return len(np.unique(np.concatenate([hi[valid], lo[valid]])))


def sat_words(cell) -> int:
    """The fewest SAT words (all three channels) one gaze's taps touch,
    over :data:`GAZES`."""
    h, w = cell["source_height"], cell["source_width"]
    gx = grid_axis(cell["reduced_width"], w)
    gy = grid_axis(cell["reduced_height"], h)
    return 3 * min(_distinct(gx, scaled(cx, w), w, True) * _distinct(gy, scaled(cy, h), h, False)
                   for cx, cy in GAZES)


def cost(cell):
    hr, wr = cell["reduced_height"], cell["reduced_width"]
    n = cell["viewers"]
    nbytes = n * (3 * hr * wr + 9 * (wr + hr) + 4 * sat_words(cell))
    ops = 4 * n * 3 * hr * wr
    return nbytes, ops
