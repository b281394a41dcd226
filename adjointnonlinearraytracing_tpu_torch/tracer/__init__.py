"""Eikonal steppers (plain versions) and the differentiable tracing API."""

from . import eikonal  # noqa: F401
from .api import (trace, trace_ad, trace_cable, trace_cable_ad, trace_plane,  # noqa: F401
                  trace_plane_ad, trace_sdf, trace_sdf_ad, trace_target, trace_target_ad)
from .checkpointed import trace_cable_exact, trace_exact  # noqa: F401
