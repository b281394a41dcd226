"""Scalar fields the rays are traced through, and the RBF toolkit of the sensors."""

from . import grid, rbf  # noqa: F401
from .grid import GridField  # noqa: F401
from .rbf import RbfGrid, rbf_tent, rbf_cubic, render_gradient  # noqa: F401
