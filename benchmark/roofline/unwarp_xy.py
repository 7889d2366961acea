"""``unwarp_xy`` (kernels/csrc/unwarp.cu), one restore: the least bytes
and operations the call needs.

Bytes, each read once and written once: the (3, Hr, Wr) uint8 reduced
frame, the per-axis vectors (``lo``, ``hi``, ``num``, ``den`` int32 for
each of the W columns and H rows) and the (3, H, W) uint8 restored frame.
Operations: two blends of two taps per output value (a multiply-add each
and a scale).  Bytes bound it (4x the bound on operations)."""

MATCH = "unwarp_xy_kernel"


def cost(cell):
    h, w = cell["source_height"], cell["source_width"]
    hr, wr = cell["reduced_height"], cell["reduced_width"]
    nbytes = 3 * hr * wr + 16 * (w + h) + 3 * h * w
    ops = 6 * 3 * h * w
    return nbytes, ops
