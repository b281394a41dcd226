"""Eikonal steppers (plain versions) and the differentiable tracing API."""

from . import eikonal  # noqa: F401
from .api import trace, trace_ad  # noqa: F401
from .checkpointed import trace_exact  # noqa: F401
