"""Eikonal steppers (plain versions) and the differentiable tracing API."""

from . import eikonal  # noqa: F401
from .api import trace, trace_ad, trace_cable, trace_cable_ad  # noqa: F401
from .checkpointed import trace_cable_exact, trace_exact  # noqa: F401
