"""Ray-bundle generators (sources)."""

from . import sources  # noqa: F401
from .sources import Rays  # noqa: F401
