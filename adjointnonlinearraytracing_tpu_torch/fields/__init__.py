"""Scalar fields the rays are traced through."""

from . import grid  # noqa: F401
from .grid import GridField  # noqa: F401
