"""Scalar fields the rays are traced through, and the RBF toolkit of the sensors.

Exports every name the JAX package's ``fields`` imports or lists in ``__all__``.
"""

from . import grid, rbf  # noqa: F401
from .grid import (  # noqa: F401
    GridField,
    eval_grad,
    eval_hess,
    hess_matvec,
    splat,
    splat_delta,
    inbounds,
    escaped,
    upres_volume,
)
from .cylinder import (  # noqa: F401
    CylinderField,
    cyl_eval_grad,
    cyl_eval_hess,
    cyl_hess_matvec,
    cyl_splat_delta,
    cyl_inbounds,
    cyl_escaped,
    upres_profile,
    upres_profile_midpoint,
    cyl_render,
    cyl_render2,
)
from .rbf import RbfGrid, rbf_tent, rbf_cubic, render_gradient  # noqa: F401
from .cells import CellField, build_cell_table  # noqa: F401
from .sdf_utils import get_pts_sdf, get_opp_pts  # noqa: F401

__all__ = [
    "GridField", "eval_grad", "eval_hess", "hess_matvec", "splat",
    "splat_delta", "inbounds", "escaped", "upres_volume",
    "CylinderField", "cyl_eval_grad", "cyl_eval_hess", "cyl_hess_matvec",
    "cyl_splat_delta", "cyl_inbounds", "cyl_escaped", "upres_profile",
    "upres_profile_midpoint",
    "RbfGrid", "rbf_tent", "rbf_cubic",
]
