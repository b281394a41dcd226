"""Experiments and their shared plumbing: the JAX package's experiments, and the
fuel north star (``northstar``, the twin of its root script
``run_fuel_northstar.py``)."""

from . import common, config, voxel_scenes  # noqa: F401
from . import fiber, focalstack, fuel_injection, image, luneburg, northstar  # noqa: F401
