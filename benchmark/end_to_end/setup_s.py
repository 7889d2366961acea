"""Process start to the first timed unit: imports, the CUDA context, the
kernels' libraries (built by nvcc on a checkout's first run), the inputs
and the warm-up."""


def read(run):
    return run.setup_s
