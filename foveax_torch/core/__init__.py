"""Transform math on tensors: the grid, the sampler taps, the inverse map
and the exact unwarp; the CLI-only samplers, log-polar, gnomonic, the
quality metrics and the SVD-compressed SAT.  Exports what the JAX
package's ``foveax.core`` exports, apart from its ``delta_1d`` (a traced
float32 delta; the port computes deltas on the host in float64,
:func:`delta64`); ``sample_rect_direct`` is importable from here but not
in ``__all__``, as in the JAX package."""

from foveax_torch.core.direct import sample_rect_direct
from foveax_torch.core.gnomonic import gnomonic_project
from foveax_torch.core.logpolar import (
    LogPolarGrid,
    build_pyramid,
    logpolar_gaussian_blur,
    make_logpolar_grid,
    sample_logpolar,
    sample_logpolar_pyramid,
    unwarp_logpolar,
)
from foveax_torch.core.logrect import (
    LogRectGrid,
    delta64,
    lam,
    make_grid,
    make_point_grid,
)
from foveax_torch.core.metrics import (
    eccentricity_weighted_psnr,
    foveal_psnr,
    mse,
    psnr,
)
from foveax_torch.core.sample import (
    expand_sampled_rect,
    sample_rect_from_sat,
    sample_rect_point,
)
from foveax_torch.core.sat import build_sat, decode_sat
from foveax_torch.core.svd_sat import (
    SVDSat,
    compress_sat,
    create_reduced_sat,
    reconstruct_sat,
    sample_from_reduced_sat,
)
from foveax_torch.core.unwarp import unwarp_rect

__all__ = [
    "LogRectGrid",
    "delta64",
    "lam",
    "make_grid",
    "make_point_grid",
    "build_sat",
    "decode_sat",
    "sample_rect_from_sat",
    "sample_rect_point",
    "expand_sampled_rect",
    "unwarp_rect",
    "LogPolarGrid",
    "make_logpolar_grid",
    "sample_logpolar",
    "logpolar_gaussian_blur",
    "unwarp_logpolar",
    "build_pyramid",
    "sample_logpolar_pyramid",
    "gnomonic_project",
    "mse",
    "psnr",
    "foveal_psnr",
    "eccentricity_weighted_psnr",
    "SVDSat",
    "compress_sat",
    "reconstruct_sat",
    "create_reduced_sat",
    "sample_from_reduced_sat",
]
