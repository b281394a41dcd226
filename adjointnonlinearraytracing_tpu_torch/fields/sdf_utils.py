"""SDF-surface ray spawning, in plain torch.

Twin of ``adjointnonlinearraytracing_tpu/fields/sdf_utils.py``.
:func:`get_pts_sdf` projects random points onto the zero level set of a voxel
SDF (walking along the SDF gradient) and returns surface positions with the
inward directions, the start rays of SDF-bounded scenes (``trace_sdf``);
:func:`get_opp_pts` marches points through the interior to the opposite
surface.  Both iterate a fixed point with per-point masks and an iteration
cap (1000; ``3 * res``), as the JAX ``while_loop`` does; here an iteration
touches only the points still moving, which gives the same numbers.

The random draw is a ``torch.Generator``'s; :func:`get_pts_sdf_from_samples`
is the body, which takes the uniform samples, so that a test can feed both
packages the same draw.  It runs where its tensors live.
"""

from __future__ import annotations

import torch

from .rbf import RbfGrid, get_linear

#: the projection's iteration cap
PTS_SDF_ITERS = 1000


def get_pts_sdf_from_samples(sdf: torch.Tensor, u: torch.Tensor, width: float):
    """Body of :func:`get_pts_sdf`: ``u`` (nrays, 3) uniform in ``[0, 1)``."""
    res = sdf.shape[0]
    h = width / (res - 1)
    pts = width * u
    vol = RbfGrid.create(h * sdf, h)

    dist, distx = get_linear(vol, pts)
    dnorm = torch.linalg.norm(distx, dim=-1, keepdim=True)
    vel = distx / torch.where(dnorm == 0, torch.ones_like(dnorm), dnorm)
    pos = pts - dist[:, None] * vel
    pos = pos - h * distx / 10

    eps = 1.0 / 10
    mask = get_linear(vol, pos)[0] > -1e-6
    i = 0
    while i < PTS_SDF_ITERS and bool(mask.any()):
        sel = mask.nonzero()[:, 0]
        p = pos[sel]
        dist = get_linear(vol, p)[0]
        p = p - eps * dist[:, None] * vel[sel] / (i + 1)
        pos[sel] = p
        mask[sel] = get_linear(vol, p)[0] > -1e-6
        i += 1
    return pos, -vel


def get_pts_sdf(gen: torch.Generator, sdf: torch.Tensor, nrays: int, width: float):
    """Project random points onto the SDF surface; returns ``(pos, vel)``.

    ``sdf`` is a ``(res, res, res)`` distance volume on the span ``[0, width]``
    in *voxel units* (world distance / h, the reference's convention), indexed
    ``[x, y, z]`` as ``fields/rbf.py`` grids are; ``vel`` is the inward surface
    direction (``-grad``).  Draws ``nrays`` uniform points from ``gen`` (on its
    device, in ``sdf``'s type)."""
    u = torch.rand((nrays, 3), generator=gen, dtype=sdf.dtype, device=gen.device)
    return get_pts_sdf_from_samples(sdf, u, width)


def get_opp_pts(sdf: torch.Tensor, pts: torch.Tensor, v: torch.Tensor, width: float):
    """March interior points along ``v`` in half-voxel steps to the opposite
    surface (the first position where the SDF reads ``>= 0``); points that
    start outside stay where they are."""
    res = sdf.shape[0]
    h = width / (res - 1)
    vol = RbfGrid.create(sdf, h)

    mask = get_linear(vol, pts)[0] < 0
    pos = pts.clone()
    i = 0
    while i < res * 3 and bool(mask.any()):
        sel = mask.nonzero()[:, 0]
        p = pos[sel] + h * v[sel] / 2
        pos[sel] = p
        mask[sel] = get_linear(vol, p)[0] < 0
        i += 1
    return pos
