"""Ray-bundle generators (sources): the ones the fuel-injection trainer reaches.

Twin of ``adjointnonlinearraytracing_tpu/sources/sources.py``.  Every
generator returns initial conditions ``(x, v, planes)`` where ``planes`` is
the per-ray sensor-plane stack ``[plane_origin, plane_normal, plane_tangent]``
``(N, 3, 3)``, plus a boolean ``mask`` ``(N,)``: rejected rays (circle crops)
stay in the batch with ``mask=False`` and must be excluded from losses by the
caller; rows are never dropped.

Randomness comes from an explicit ``torch.Generator`` in place of the JAX
package's key, and the tensors are made on the generator's device.  Where the
JAX package splits its key into one key per view, the multi-view rigs here
draw from the one generator in view order.  Each random source is a draw
(:func:`_uniform`, the only place a random number is made) followed by a
deterministic body (``*_from_samples``) that takes the drawn uniforms as
tensors, so that the same samples can be fed to both packages.

Angles are degrees.  ``pixels`` is an ``(H, W)`` tuple and ``spp`` the samples
per pixel; the batch size is ``H * W * spp``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..convert import require_device


class Rays(NamedTuple):
    x: torch.Tensor        # (N, 3) positions
    v: torch.Tensor        # (N, 3) directions
    planes: torch.Tensor   # (N, 3, 3) [origin, normal, tangent]
    mask: torch.Tensor     # (N,) live-ray mask

    def astuple(self):
        return self.x, self.v, self.planes


def _full_mask(n, device):
    return torch.ones((n,), dtype=torch.bool, device=device)


def _uniform(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """Uniform samples in ``[0, 1)`` of ``shape`` on the generator's device."""
    return torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)


def _axis(values, like: torch.Tensor) -> torch.Tensor:
    """``values`` (a unit vector) tiled to ``like``'s ``(N, 3)``, dtype and device."""
    return torch.tensor([values], dtype=like.dtype, device=like.device).repeat(like.shape[0], 1)


def rotate_ray3(x: torch.Tensor, angle, vert: bool = False) -> torch.Tensor:
    """3D rotation about z (or x when ``vert``) by ``angle`` degrees."""
    theta = torch.deg2rad(torch.as_tensor(angle, dtype=x.dtype, device=x.device))
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    if vert:
        rows = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
    else:
        rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    rot = torch.stack([torch.stack(r) for r in rows])
    return x @ rot.T


def _standard_planes(v_template, angle, width, sensor_dist, xaxis):
    """The common sensor-plane construction used by the 3D sources."""
    plane_v = rotate_ray3(_axis([0.0, 1.0, 0.0], v_template), angle, vert=xaxis)
    plane_t = rotate_ray3(_axis([0.0, 0.0, 1.0], v_template), angle, vert=xaxis)
    plane_x = (sensor_dist + width / 2) * plane_v + width / 2
    return torch.stack([plane_x, plane_v, plane_t], dim=1)


def _pixel_grid(pixels, width, like: torch.Tensor, centred: bool):
    """The ``(ph, pw)`` pixel lattice of a sensor of side ``width`` about 0:
    pixel centres when ``centred``, lower corners otherwise."""
    shift = 0.5 if centred else 0.0
    rng = [width * ((torch.arange(p, dtype=like.dtype, device=like.device) + shift) / p - 0.5)
           for p in pixels]
    return torch.meshgrid(*rng, indexing="ij")


def rotate_pts_to_source(pts, angle, width, circle=False, xaxis=False,
                         sensor_dist=1.0) -> Rays:
    """Flatten grid points into a rotated parallel beam."""
    x = torch.stack([p.reshape(-1) for p in pts], dim=-1)
    n = x.shape[0]
    if circle:
        mask = torch.linalg.norm(x, dim=-1) < width / 2
    else:
        mask = _full_mask(n, x.device)
    v = _axis([0.0, 1.0, 0.0], x)
    t = _axis([0.0, 0.0, 1.0], x)

    x = rotate_ray3(x, angle, vert=xaxis) + width / 2
    v = rotate_ray3(v, angle, vert=xaxis)
    t = rotate_ray3(t, angle, vert=xaxis)
    x = x - width * v / 2

    plane_x = (sensor_dist + width / 2) * v + width / 2
    planes = torch.stack([plane_x, v, t], dim=1)
    return Rays(x, v, planes, mask)


def plane_source3(angle, num_rays: int, width, circle=False, dtype=torch.float32,
                  device="cuda") -> Rays:
    """Deterministic 3D parallel-beam grid of ``num_rays^2`` rays."""
    dev = require_device(device)
    lin = torch.linspace(-width / 2, width / 2, num_rays, dtype=dtype, device=dev)
    g0, g1 = torch.meshgrid(lin, lin, indexing="ij")
    pts = [g0, torch.zeros_like(g0), g1]
    return rotate_pts_to_source(pts, angle, width, circle=circle)


def plane_source3_from_samples(offset, angle, pixels, spp: int, width, circle=False,
                               xaxis=False, sensor_dist=1.0, independent=False) -> Rays:
    """Body of :func:`plane_source3_rand`; ``offset`` is its ``(2*spp, ph, pw)``
    uniform draw in ``[0, 1)``."""
    ph, pw = pixels
    offset = offset * width
    zeros = torch.zeros_like(offset[:spp])
    if independent:
        pts = [offset[:spp] - width / 2, zeros, offset[spp:] - width / 2]
    else:
        g0, g1 = _pixel_grid(pixels, width, offset, centred=False)
        pts = [g0[None] + offset[:spp] / ph, zeros, g1[None] + offset[spp:] / pw]
    return rotate_pts_to_source(pts, angle, width, circle=circle, xaxis=xaxis,
                                sensor_dist=sensor_dist)


def plane_source3_rand(gen, angle, pixels, spp: int, width, circle=False, xaxis=False,
                       sensor_dist=1.0, independent=False, dtype=torch.float32) -> Rays:
    """Stratified-random planar source."""
    ph, pw = pixels
    offset = _uniform(gen, (2 * spp, ph, pw), dtype)
    return plane_source3_from_samples(offset, angle, pixels, spp, width, circle=circle,
                                      xaxis=xaxis, sensor_dist=sensor_dist,
                                      independent=independent)


def point_source3_from_samples(offset, angle, pixels, spp: int, width, circle=False,
                               xaxis=False, sensor_dist=1.0) -> Rays:
    """Body of :func:`point_source3_rand`; ``offset`` is its ``(2*spp, ph, pw)``
    uniform draw in ``[0, 1)``."""
    offset = offset - 0.5
    g0, g1 = _pixel_grid(pixels, width, offset, centred=True)
    p0 = (g0[None] + offset[:spp]).reshape(-1)
    p1 = (g1[None] + offset[spp:]).reshape(-1)

    vels = torch.stack([p0, width * torch.ones_like(p0), p1], dim=-1)
    vel = vels / torch.linalg.norm(vels, dim=-1, keepdim=True)
    n = vel.shape[0]
    if circle:
        mask = torch.linalg.norm(torch.stack([p0, p1]), dim=0) < width / 2
    else:
        mask = _full_mask(n, vel.device)

    pos = torch.tensor([[0.0, -width / 2, 0.0]], dtype=vel.dtype,
                       device=vel.device).repeat(n, 1)
    x = rotate_ray3(pos, angle, vert=xaxis) + width / 2
    v = rotate_ray3(vel, angle, vert=xaxis)

    plane_v = rotate_ray3(_axis([0.0, 1.0, 0.0], v), angle, vert=xaxis)
    plane_t = rotate_ray3(_axis([0.0, 0.0, 1.0], v), angle, vert=xaxis)
    plane_x = sensor_dist * width * plane_v / 2 + width / 2
    planes = torch.stack([plane_x, plane_v, plane_t], dim=1)
    return Rays(x, v, planes, mask)


def point_source3_rand(gen, angle, pixels, spp: int, width, circle=False, xaxis=False,
                       sensor_dist=1.0, dtype=torch.float32) -> Rays:
    """Random point source fanning to the stratified sensor grid.  The plane
    origin is ``sensor_dist * width / 2`` out."""
    ph, pw = pixels
    offset = _uniform(gen, (2 * spp, ph, pw), dtype)
    return point_source3_from_samples(offset, angle, pixels, spp, width, circle=circle,
                                      xaxis=xaxis, sensor_dist=sensor_dist)


def area_source3_bias_from_samples(offset, tosense, angle, pixels, spp: int, width,
                                   circle=False, xaxis=False, sensor_dist=1.0):
    """Body of :func:`area_source3_rand_bias`; ``offset`` ``(2*spp, ph, pw)`` and
    ``tosense`` ``(2, N)`` are its two uniform draws in ``[0, 1)``."""
    ph, _ = pixels
    offset = (offset - 0.5) * (width / ph)
    g0, g1 = _pixel_grid(pixels, width, offset, centred=True)
    pts = [g0[None] + offset[:spp], torch.zeros_like(offset[:spp]), g1[None] + offset[spp:]]
    pos = torch.stack([p.reshape(-1) for p in pts], dim=-1)
    n = pos.shape[0]
    if circle:
        mask = torch.linalg.norm(pos, dim=-1) < width / 2
    else:
        mask = _full_mask(n, pos.device)

    pt = -pos
    ydir = torch.tensor([[0.0, 1.0, 0.0]], dtype=pos.dtype, device=pos.device)
    pos = pos - (sensor_dist + width / 2) * ydir
    pt = pt + (sensor_dist + width / 2) * ydir

    tosense = (tosense - 0.5) * width
    target = torch.stack([tosense[0], width * torch.ones_like(tosense[0]) / 2, tosense[1]],
                         dim=-1)

    vel = target - pos
    vel = vel / torch.linalg.norm(vel, dim=-1, keepdim=True)
    tpv = sensor_dist / vel[:, 1]
    npos = pos + tpv[:, None] * vel

    xt = rotate_ray3(pt, angle, vert=xaxis) + width / 2
    x = rotate_ray3(npos, angle, vert=xaxis) + width / 2
    v = rotate_ray3(vel, angle, vert=xaxis)
    planes = _standard_planes(v, angle, width, sensor_dist, xaxis)
    return Rays(x, v, planes, mask), xt, tpv


def area_source3_rand_bias(gen, angle, pixels, spp: int, width, circle=False, xaxis=False,
                           sensor_dist=1.0, dtype=torch.float32):
    """Area source biased to hit the sensor.

    Returns ``(Rays, xt, tpv)``: per-ray backprojected target points and the
    plane-hit parameter.
    """
    ph, pw = pixels
    offset = _uniform(gen, (2 * spp, ph, pw), dtype)
    tosense = _uniform(gen, (2, spp * ph * pw), dtype)
    return area_source3_bias_from_samples(offset, tosense, angle, pixels, spp, width,
                                          circle=circle, xaxis=xaxis, sensor_dist=sensor_dist)


# ---------------------------------------------------------------------------
# multi-view rigs
# ---------------------------------------------------------------------------

def _cat_rays(views: Sequence[Rays]):
    rays = Rays(*(torch.cat(parts) for parts in zip(*views)))
    return rays, [r.x.shape[0] for r in views]


def _view_angles(nviews, angle_span):
    return np.linspace(0, angle_span, nviews + 1)[:nviews]


def rays_in_sphere(nviews, rays_per_view, width, angle_span=360, circle=False,
                   dtype=torch.float32, device="cuda"):
    views = [plane_source3(a, rays_per_view, width, circle=circle, dtype=dtype, device=device)
             for a in _view_angles(nviews, angle_span)]
    return _cat_rays(views)


def rand_rays_in_sphere(gen, nviews, im_res, spp, width, angle_span=360, circle=False,
                        xaxis=False, sensor_dist=1.0, indep=False, dtype=torch.float32):
    views = [plane_source3_rand(gen, a, im_res, spp, width, circle=circle, xaxis=xaxis,
                                sensor_dist=sensor_dist, independent=indep, dtype=dtype)
             for a in _view_angles(nviews, angle_span)]
    return _cat_rays(views)


def rand_ptrays_in_sphere(gen, nviews, im_res, spp, width, angle_span=360, circle=False,
                          xaxis=False, sensor_dist=0.0, dtype=torch.float32):
    views = [point_source3_rand(gen, a, im_res, spp, width, circle=circle, xaxis=xaxis,
                                sensor_dist=sensor_dist, dtype=dtype)
             for a in _view_angles(nviews, angle_span)]
    return _cat_rays(views)


def rand_area_in_sphere(gen, nviews, im_res, spp, width, angle_span=360, circle=False,
                        xaxis=False, sensor_dist=1.0, dtype=torch.float32):
    out = [area_source3_rand_bias(gen, a, im_res, spp, width, circle=circle, xaxis=xaxis,
                                  sensor_dist=sensor_dist, dtype=dtype)
           for a in _view_angles(nviews, angle_span)]
    views, targets, dists = zip(*out)
    rays, nrays = _cat_rays(views)
    return rays, torch.cat(targets), torch.cat(dists), nrays
