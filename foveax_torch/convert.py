"""State carried across from the JAX package.

The system has no weights: its only state is the log-rectilinear grid.
:func:`grid_from_numpy` takes the JAX grid's vectors as numpy arrays
(``np.asarray(grid.gx)``, ``np.asarray(grid.gy)``), so that both packages
can be fed the same grid.
"""

from foveax_torch.core.logrect import grid_from_numpy

__all__ = ["grid_from_numpy"]
