"""foveax_torch — the foveated 360° video path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``foveax`` beside it, which stays the reference.
The layout mirrors foveax's: ``core`` (grid, taps, inverse map, exact
unwarp), ``kernels`` (the CUDA kernels, each with a plain PyTorch twin),
``pipeline``, ``serve`` (the streaming server and client), ``io`` (video
sources, wire codecs, fMP4 muxing) and ``native`` (the C++ muxer and
FFmpeg codec shim, built with ``make`` at first use).  The package imports
neither JAX nor foveax.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, where every kernel is replaced by its plain
version.
"""

from foveax_torch.config import DEFAULT_CONFIG, FoveaxConfig, reduced_dim
from foveax_torch.core.logrect import LogRectGrid, make_grid
from foveax_torch.pipeline.frames import FoveationPipeline
from foveax_torch.serve import FoveaxClient, FoveaxServer

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_CONFIG",
    "FoveaxClient",
    "FoveaxConfig",
    "FoveaxServer",
    "FoveationPipeline",
    "LogRectGrid",
    "make_grid",
    "reduced_dim",
    "__version__",
]
