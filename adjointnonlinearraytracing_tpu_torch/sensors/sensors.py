"""Sensor models: plane propagation.

Twin of ``adjointnonlinearraytracing_tpu/sensors/sensors.py``, as far as the
fuel-injection trainer reaches.  The nonlinear trace ends at the volume
boundary; :func:`trace_rays_to_plane` propagates the exit rays linearly to a
sensor plane.  The image splats and texture losses of the JAX module depend
on ``fields/rbf.py`` and are not ported yet.
"""

from __future__ import annotations

import torch


def trace_rays_to_plane(rays, plane):
    """Linear propagation to the plane: ``t = n.(p - x) / n.v``.

    ``rays`` = ``(x, v)`` with shapes ``(N, 3)``; ``plane`` = ``(p, n)``
    broadcastable to ``(N, 3)``.  Differentiable in all inputs through plain
    autograd.
    """
    x, v = rays
    p, n = plane
    p = torch.broadcast_to(p, x.shape)
    n = torch.broadcast_to(n, x.shape)
    t = (n * (p - x)).sum(dim=-1) / (n * v).sum(dim=-1)
    return x + t[:, None] * v, v
