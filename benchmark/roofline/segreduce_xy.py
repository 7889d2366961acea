"""``segment_reduce_xy`` (kernels/csrc/segreduce.cu), one call over the
cell's viewers: the least bytes and operations the call needs.

Bytes, each read once and written once: the (3, H, W) uint8 frame; per
gaze the column taps (``pxc``, ``pxmc`` int32 and ``valid_x`` bool, Wr
each) and the row taps (the same, Hr each); the (N, 3, Hr, Wr) uint8
box means.  Operations: the summed-area formulation, two adds per source
value and three adds and a divide per output value.  Bytes bound it by
far."""

MATCH = "segment_reduce_xy_kernel"


def cost(cell):
    h, w = cell["source_height"], cell["source_width"]
    hr, wr = cell["reduced_height"], cell["reduced_width"]
    n = cell["viewers"]
    nbytes = 3 * h * w + n * 9 * (wr + hr) + n * 3 * hr * wr
    ops = 2 * 3 * h * w + 4 * n * 3 * hr * wr
    return nbytes, ops
