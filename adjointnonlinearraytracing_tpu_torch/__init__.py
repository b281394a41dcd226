"""PyTorch / CUDA port of the differentiable nonlinear (eikonal) ray tracer.

The twin of ``adjointnonlinearraytracing_tpu`` for one NVIDIA Hopper GPU.
Sub-packages keep the JAX package's names (``fields.grid``,
``tracer.eikonal``, ``tracer.api``, ``sources.sources``, ``sensors.sensors``,
``opt.multires``, ``experiments.fuel_injection``, ``benchmarks.scenes``, ...)
so a reader finds a module's twin by path; ``kernels`` holds the hand-written
CUDA sources, their loader and their wrappers; ``convert`` carries state
between numpy, the JAX package's files and the port.

Importing this package builds nothing and needs neither a GPU, ``nvcc`` nor
``triton``; the kernels are compiled the first time one is launched.
"""

from . import fields, tracer  # noqa: F401
from .fields.grid import GridField  # noqa: F401
