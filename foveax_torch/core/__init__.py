"""Transform math on tensors: the grid, the sampler taps, the inverse map
and the exact unwarp."""
