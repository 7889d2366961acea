"""State carried across from the JAX package.

The system has no weights: its state is the log-rectilinear grid, the
log-polar delta grid and, in the SVD serve mode, a SAT's factors.
:func:`grid_from_numpy` takes the JAX grid's vectors as numpy arrays
(``np.asarray(grid.gx)``, ``np.asarray(grid.gy)``),
:func:`logpolar_grid_from_numpy` its log-polar grid's
``np.asarray(grid.deltas)``, and :func:`svd_sat_from_numpy` an
``SVDSat``'s five arrays, so that both packages can be fed the same state.
"""

from foveax_torch.core.logpolar import logpolar_grid_from_numpy
from foveax_torch.core.logrect import grid_from_numpy
from foveax_torch.core.svd_sat import svd_sat_from_numpy

__all__ = ["grid_from_numpy", "logpolar_grid_from_numpy", "svd_sat_from_numpy"]
