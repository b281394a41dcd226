"""Eikonal steppers (plain versions) and the differentiable tracing API.

Exports every name of the JAX package's ``tracer.__all__``."""

from . import eikonal  # noqa: F401
from .api import (trace, trace_ad, trace_cable, trace_cable_ad, trace_plane,  # noqa: F401
                  trace_plane_ad, trace_sdf, trace_sdf_ad, trace_target, trace_target_ad)
from .checkpointed import (trace_cable_exact, trace_exact, trace_plane_exact,  # noqa: F401
                           trace_sdf_exact, trace_target_exact)
from .eikonal import (backtrace, backtrace_cable, backtrace_sdf, max_steps_bwd,  # noqa: F401
                      max_steps_fwd, trace_scan)

__all__ = [
    "trace", "trace_plane", "trace_target", "trace_sdf", "trace_cable",
    "trace_exact", "trace_plane_exact", "trace_target_exact",
    "trace_sdf_exact", "trace_cable_exact",
    "trace_ad", "trace_plane_ad", "trace_target_ad", "trace_sdf_ad",
    "trace_cable_ad", "max_steps_fwd", "max_steps_bwd", "backtrace",
    "backtrace_sdf", "backtrace_cable", "trace_scan",
]
