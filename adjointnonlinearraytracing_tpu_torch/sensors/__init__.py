"""Sensor models: propagation of exit rays to a sensor plane."""

from .sensors import trace_rays_to_plane  # noqa: F401
