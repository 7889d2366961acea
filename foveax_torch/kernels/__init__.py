"""Hand-written CUDA kernels for Hopper (``csrc/``), each behind a wrapper
with a plain PyTorch twin and a launch counter."""
