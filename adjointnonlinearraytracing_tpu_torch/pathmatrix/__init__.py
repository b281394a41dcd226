"""The 2008 path-matrix baseline: host-side operators and solvers
(``path_matrix``) and the reconstruction driver (``fuel2008``)."""

from . import path_matrix  # noqa: F401
from .fuel2008 import fuel_reconstruction  # noqa: F401
