"""Ray-bundle generators (sources), 2D and 3D, and the 1D intensity sensor.

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
(:func:`_uniform` and :func:`_normal`, the only places a random number is
made) followed by a deterministic body (``*_from_samples``) that takes the
drawn samples as tensors, so that the same samples can be fed to both
packages.  Where the JAX package splits a key
for two draws, the port draws them from the one generator in the same order.

Angles are degrees.  ``pixels`` is an ``(H, W)`` tuple and ``spp`` the samples
per pixel; the batch size is ``H * W * spp``.  The 2D functions
(:func:`rotate_ray`, :func:`plane_source`, :func:`rays_in_circle`,
:func:`create_sensor`, :func:`render_intensities`) take rays ``(N, 2)``.
"""

from __future__ import annotations

import math
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


def _normal(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """Standard normal samples of ``shape`` on the generator's device."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def _axis(values, like: torch.Tensor) -> torch.Tensor:
    """``values`` (a unit vector) tiled to ``like``'s ``(N, 3)``, dtype and device."""
    return torch.tensor([values], dtype=like.dtype, device=like.device).repeat(like.shape[0], 1)


def rotate_ray(x: torch.Tensor, angle) -> torch.Tensor:
    """2D rotation of the rows of ``x`` ``(N, 2)`` by ``angle`` degrees."""
    theta = torch.deg2rad(torch.as_tensor(angle, dtype=x.dtype, device=x.device))
    c, s = torch.cos(theta), torch.sin(theta)
    rot = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    return x @ rot.T


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


def random_rotmat_from_samples(q: torch.Tensor) -> torch.Tensor:
    """Body of :func:`random_rotmat`: the rotation of the quaternion ``q`` (4,)
    after normalising it."""
    q = q / torch.linalg.norm(q)
    w, x, y, z = q
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)]),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)]),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]),
    ])


def random_rotmat(gen, dtype=torch.float32) -> torch.Tensor:
    """Uniform random SO(3) matrix (quaternion method): four normals drawn."""
    return random_rotmat_from_samples(_normal(gen, (4,), dtype))


def _rotate_about_centre(R, x, v, planes, span):
    c = span / 2
    xn = (x - c) @ R.T + c
    vn = v @ R.T
    sp = (planes[:, 0, :] - c) @ R.T + c
    sn = planes[:, 1, :] @ R.T
    st = planes[:, 2, :] @ R.T
    return xn, vn, torch.stack([sp, sn, st], dim=1)


def random_rotate_ic_from_samples(q, x, v, planes, span):
    """Body of :func:`random_rotate_ic`; ``q`` is its four normals."""
    return _rotate_about_centre(random_rotmat_from_samples(q).to(x.dtype), x, v, planes, span)


def random_rotate_ic(gen, x, v, planes, span):
    """Rotate rays and planes by a random rotation about the volume centre."""
    return random_rotate_ic_from_samples(_normal(gen, (4,), x.dtype), x, v, planes, span)


def rotate_ic(x, v, planes, angle, span, vert=False):
    """Rotate rays and planes by a fixed angle (degrees), then shift by ``span / 2``."""
    xr = rotate_ray3(x, angle, vert=vert) + span / 2
    vr = rotate_ray3(v, angle, vert=vert)
    spr = rotate_ray3(planes[:, 0, :], angle, vert=vert) + span / 2.0
    snr = rotate_ray3(planes[:, 1, :], angle, vert=vert)
    strr = rotate_ray3(planes[:, 2, :], angle, vert=vert)
    return xr, vr, torch.stack([spr, snr, strr], dim=1)


def hatbox_from_samples(uz, ut, v: torch.Tensor, angle) -> torch.Tensor:
    """Body of :func:`hatbox_sample`; ``uz`` and ``ut`` ``(N,)`` are its two
    uniform draws in ``[0, 1)``."""
    basis = torch.tensor([[0.0, 0.0, 1.0]], dtype=v.dtype, device=v.device)
    rang = torch.deg2rad(torch.as_tensor(angle, dtype=v.dtype, device=v.device)) / 2
    dist = torch.cos(rang)
    z = uz * (1 - dist) + dist
    theta = 2 * math.pi * ut
    scale = torch.sqrt(1 - z ** 2)
    x = torch.cos(theta) * scale
    y = torch.sin(theta) * scale
    t1 = torch.linalg.cross(torch.broadcast_to(basis, v.shape), v, dim=-1)
    t2 = torch.linalg.cross(t1, v, dim=-1)
    return x[:, None] * t1 + y[:, None] * t2 + z[:, None] * v


def hatbox_sample(gen, v: torch.Tensor, angle) -> torch.Tensor:
    """Uniform directions in a cone of ``angle`` degrees around each ``v``
    (Archimedes' hat-box)."""
    n = v.shape[0]
    uz = _uniform(gen, (n,), v.dtype)
    ut = _uniform(gen, (n,), v.dtype)
    return hatbox_from_samples(uz, ut, v, angle)


def perturb_vector_from_samples(p: torch.Tensor, v: torch.Tensor, spp: int) -> torch.Tensor:
    """Body of :func:`perturb_vector`; ``p`` ``(N * spp, d)`` is its normal draw."""
    p = p / torch.linalg.norm(p, dim=-1, keepdim=True)
    vn = v.repeat(spp, 1) + p
    return vn / torch.linalg.norm(vn, dim=-1, keepdim=True)


def perturb_vector(gen, v: torch.Tensor, spp: int) -> torch.Tensor:
    """Each direction of ``v`` ``(N, d)`` jittered ``spp`` times by a random unit
    vector and re-normalised; the copies are stacked copy by copy."""
    return perturb_vector_from_samples(_normal(gen, (v.shape[0] * spp, v.shape[1]), v.dtype),
                                       v, spp)


def plane_source(angle, num_rays: int, width, dtype=torch.float32, device="cuda"):
    """2D parallel beam of ``num_rays`` rays across ``width``, turned by ``angle``
    degrees.  Returns ``(x, v, planes)``: ``planes`` ``(N, 2, 2)`` is the
    sensor line's ``[origin, normal]``."""
    dev = require_device(device)
    x = torch.stack([torch.linspace(-width / 2, width / 2, num_rays, dtype=dtype, device=dev),
                     torch.zeros(num_rays, dtype=dtype, device=dev)], dim=1)
    v = rotate_ray(torch.tensor([[0.0, 1.0]], dtype=dtype, device=dev).repeat(num_rays, 1),
                   angle)
    x = rotate_ray(x, angle) + width / 2
    x = x - np.sqrt(2) * width * v / 2
    plane_x = np.sqrt(2) * width * v / 2 + width / 2
    return x, v, torch.stack([plane_x, v], dim=1)


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


def point_source3(angle, pixels, spp: int, width, cone_angle=90, xaxis=False, sensor_dist=0.0,
                  circle=False, dtype=torch.float32, device="cuda") -> Rays:
    """Deterministic point source with a cone fan of ``(p * floor(sqrt(spp)))``
    rays along each pixel axis; ``circle`` is accepted and, as in the JAX
    package, masks nothing."""
    dev = require_device(device)
    ang_rad = np.radians(cone_angle / 2)
    spp_side = max(int(np.floor(np.sqrt(spp))), 1)
    axes = [torch.linspace(-ang_rad, ang_rad, p * spp_side, dtype=dtype, device=dev)
            for p in pixels]
    theta, phi = (a.reshape(-1) for a in torch.meshgrid(*axes, indexing="ij"))
    vel = torch.stack([torch.cos(theta) * torch.sin(phi), torch.cos(theta) * torch.cos(phi),
                       torch.sin(theta)], dim=-1)
    n = vel.shape[0]
    pos = torch.tensor([[0.0, -width / 2, 0.0]], dtype=dtype, device=dev).repeat(n, 1)
    vel = vel / torch.linalg.norm(vel, dim=-1, keepdim=True)

    x = rotate_ray3(pos, angle, vert=xaxis) + width / 2
    v = rotate_ray3(vel, angle, vert=xaxis)
    planes = _standard_planes(v, angle, width, sensor_dist, xaxis)
    return Rays(x, v, planes, _full_mask(n, dev))


def area_source3_cone_from_samples(offset, uz, ut, angle, pixels, spp: int, width, circle=False,
                                   xaxis=False, sensor_dist=1.0, cone_angle=90):
    """Body of :func:`area_source3_cone`; ``offset`` ``(2*spp, ph, pw)`` and the
    hat-box's ``uz``, ``ut`` ``(N,)`` are its uniform draws in ``[0, 1)``."""
    ph, _ = pixels
    offset = (offset - 0.5) * (width / ph)
    g0, g1 = _pixel_grid(pixels, width, offset, centred=True)
    pts = [g0[None] + offset[:spp], torch.full_like(offset[:spp], -width / 2),
           g1[None] + offset[spp:]]
    pos = torch.stack([p.reshape(-1) for p in pts], dim=-1)
    n = pos.shape[0]
    # as in the JAX package, the circle test includes the source plane's
    # offset |y| = width / 2, so it masks every ray
    mask = torch.linalg.norm(pos, dim=-1) < width / 2 if circle else _full_mask(n, pos.device)

    forward = _axis([0.0, 1.0, 0.0], pos)
    vel = hatbox_from_samples(uz, ut, forward, cone_angle)
    tpv = sensor_dist / vel[:, 1]

    x = rotate_ray3(pos, angle, vert=xaxis) + width / 2
    v = rotate_ray3(vel, angle, vert=xaxis)
    planes = _standard_planes(v, angle, width, sensor_dist, xaxis)
    return Rays(x, v, planes, mask), tpv


def area_source3_cone(gen, angle, pixels, spp: int, width, circle=False, xaxis=False,
                      sensor_dist=1.0, cone_angle=90, dtype=torch.float32):
    """Area source emitting into a cone of ``cone_angle`` degrees.  Returns
    ``(Rays, tpv)``."""
    ph, pw = pixels
    offset = _uniform(gen, (2 * spp, ph, pw), dtype)
    n = spp * ph * pw
    uz = _uniform(gen, (n,), dtype)
    ut = _uniform(gen, (n,), dtype)
    return area_source3_cone_from_samples(offset, uz, ut, angle, pixels, spp, width,
                                          circle=circle, xaxis=xaxis, sensor_dist=sensor_dist,
                                          cone_angle=cone_angle)


def cone_source3_from_samples(uz, ut, angle, pixels, spp: int, width, circle=False, xaxis=False,
                              sensor_dist=1.0, cone_angle=100.0) -> Rays:
    """Body of :func:`cone_source3_rand`; ``uz``, ``ut`` ``(N,)`` are the
    hat-box's uniform draws."""
    pos = torch.tensor([[0.0, -width / 2, 0.0]], dtype=uz.dtype,
                       device=uz.device).repeat(uz.shape[0], 1)
    vel = hatbox_from_samples(uz, ut, _axis([0.0, 1.0, 0.0], pos), cone_angle)

    x = rotate_ray3(pos, angle, vert=xaxis) + width / 2
    v = rotate_ray3(vel, angle, vert=xaxis)
    planes = _standard_planes(v, angle, width, sensor_dist, xaxis)
    return Rays(x, v, planes, _full_mask(pos.shape[0], pos.device))


def cone_source3_rand(gen, angle, pixels, spp: int, width, circle=False, xaxis=False,
                      sensor_dist=1.0, cone_angle=100.0, dtype=torch.float32) -> Rays:
    """Point source with random directions in a cone."""
    n = pixels[0] * pixels[1] * spp
    uz = _uniform(gen, (n,), dtype)
    ut = _uniform(gen, (n,), dtype)
    return cone_source3_from_samples(uz, ut, angle, pixels, spp, width, circle=circle,
                                     xaxis=xaxis, sensor_dist=sensor_dist, cone_angle=cone_angle)


def area_source3_from_samples(offset, hemi, angle, pixels, spp: int, width, circle=False,
                              xaxis=False, sensor_dist=1.0):
    """Body of :func:`area_source3_rand`; ``offset`` ``(2*spp, ph, pw)`` is its
    uniform draw in ``[0, 1)`` and ``hemi`` ``(N, 3)`` its normal draw."""
    ph, _ = pixels
    offset = (offset - 0.5) * (width / ph)
    g0, g1 = _pixel_grid(pixels, width, offset, centred=True)
    pts = [g0[None] + offset[:spp], torch.zeros_like(offset[:spp]), g1[None] + offset[spp:]]
    pos = torch.stack([p.reshape(-1) for p in pts], dim=-1)
    n = pos.shape[0]

    vel = hemi / torch.linalg.norm(hemi, dim=-1, keepdim=True)
    vel = torch.cat([vel[:, :1], vel[:, 1:2].abs(), vel[:, 2:]], dim=1)
    if circle:
        mask = torch.linalg.norm(pos, dim=-1) < width / 2
    else:
        mask = _full_mask(n, pos.device)

    pt = -pos
    ydir = torch.tensor([[0.0, 1.0, 0.0]], dtype=pos.dtype, device=pos.device)
    pos = pos - (sensor_dist + width / 2) * ydir
    pt = pt + (sensor_dist + width / 2) * ydir

    # a true division: a Python number over a tensor multiplies by the
    # reciprocal, and the test below lands on the face |y| = width / 2
    tpv = torch.full_like(vel[:, 1], sensor_dist) / vel[:, 1]
    npos = pos + tpv[:, None] * vel
    mask = mask & (npos.abs() <= width / 2).all(dim=-1)

    xt = rotate_ray3(pt, angle, vert=xaxis) + width / 2
    x = rotate_ray3(pos, angle, vert=xaxis) + width / 2
    v = rotate_ray3(vel, angle, vert=xaxis)
    planes = _standard_planes(v, angle, width, sensor_dist, xaxis)
    return Rays(x, v, planes, mask), xt, tpv


def area_source3_rand(gen, angle, pixels, spp: int, width, circle=False, xaxis=False,
                      sensor_dist=1.0, dtype=torch.float32):
    """Hemispherical area source: stratified points on a plane ``sensor_dist``
    below the volume, directions uniform over the half sphere facing it.  A ray
    whose straight line misses the volume's face is masked out, not dropped.
    Returns ``(Rays, xt, tpv)``."""
    ph, pw = pixels
    offset = _uniform(gen, (2 * spp, ph, pw), dtype)
    hemi = _normal(gen, (spp * ph * pw, 3), dtype)
    return area_source3_from_samples(offset, hemi, angle, pixels, spp, width, circle=circle,
                                     xaxis=xaxis, sensor_dist=sensor_dist)


def sample_sphere_from_samples(xs, uz, ut, tangent, width, cone_angle=90.0,
                               lens_type="luneburg"):
    """Body of :func:`sample_sphere`; ``xs`` and ``tangent`` ``(N, 3)`` are its
    normal draws, ``uz`` and ``ut`` ``(N,)`` the hat-box's uniform ones."""
    xn = xs / torch.linalg.norm(xs, dim=1, keepdim=True)
    v = -xn
    vn = hatbox_from_samples(uz, ut, v, cone_angle)
    vn = vn / torch.linalg.norm(vn, dim=1, keepdim=True)
    xn = xn * width / 2
    plane_t = tangent / torch.linalg.norm(tangent, dim=1, keepdim=True)
    if lens_type == "luneburg":
        plane_x = width / 2 + vn * (width / 2)
    else:
        plane_x = -xn + width / 2
    nrays = xs.shape[0]
    planes = torch.stack([plane_x, v, plane_t], dim=1)
    return Rays(xn + width / 2, vn, planes, _full_mask(nrays, xs.device)), [nrays]


def sample_sphere(gen, nrays: int, width, cone_angle=90.0, lens_type="luneburg",
                  dtype=torch.float32):
    """Rays leaving random points of the sphere of diameter ``width`` inward,
    in a cone of ``cone_angle`` degrees about the inward normal.  Returns
    ``(Rays, [nrays])``.

    As in the JAX package, the directions are re-normalised: the hat-box's
    tangent frame is made of unnormalised cross products, which for an
    arbitrary axis would give ``|v| < 1`` against the tracer's ``|v| = n``."""
    xs = _normal(gen, (nrays, 3), dtype)
    uz = _uniform(gen, (nrays,), dtype)
    ut = _uniform(gen, (nrays,), dtype)
    tangent = _normal(gen, (nrays, 3), dtype)
    return sample_sphere_from_samples(xs, uz, ut, tangent, width, cone_angle=cone_angle,
                                      lens_type=lens_type)


# ---------------------------------------------------------------------------
# multi-view rigs
# ---------------------------------------------------------------------------

def _cat_rays(views: Sequence[Rays]):
    rays = Rays(*(torch.cat(parts) for parts in zip(*views)))
    return rays, [r.x.shape[0] for r in views]


def _view_angles(nviews, angle_span):
    return np.linspace(0, angle_span, nviews + 1)[:nviews]


def rays_in_circle(nviews, rays_per_view, width, angle_span=360, dtype=torch.float32,
                   device="cuda"):
    """2D ring of ``nviews`` parallel-beam views (:func:`plane_source`);
    returns their ``(x, v, planes)`` concatenated view by view."""
    views = [plane_source(a, rays_per_view, width, dtype=dtype, device=device)
             for a in _view_angles(nviews, angle_span)]
    return tuple(torch.cat(parts) for parts in zip(*views))


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


def rand_cone_in_sphere(gen, nviews, im_res, spp, width, angle_span=360, circle=False,
                        xaxis=False, sensor_dist=1.0, cone_angle=90.0, dtype=torch.float32):
    out = [area_source3_cone(gen, a, im_res, spp, width, circle=circle, xaxis=xaxis,
                             sensor_dist=sensor_dist, cone_angle=cone_angle, dtype=dtype)
           for a in _view_angles(nviews, angle_span)]
    views, dists = zip(*out)
    rays, nrays = _cat_rays(views)
    return rays, torch.cat(dists), nrays


def rand_ptcone_in_sphere(gen, nviews, im_res, spp, width, angle_span=360, circle=False,
                          xaxis=False, sensor_dist=1.0, cone_angle=90.0, dtype=torch.float32):
    views = [cone_source3_rand(gen, a, im_res, spp, width, circle=circle, xaxis=xaxis,
                               sensor_dist=sensor_dist, cone_angle=cone_angle, dtype=dtype)
             for a in _view_angles(nviews, angle_span)]
    rays, nrays = _cat_rays(views)
    return rays, torch.zeros((nviews,), dtype=dtype, device=gen.device), nrays


def rand_rays_cube(gen, im_res, spp, width, circle=False, src_type="plane", cone_ang=90,
                   dtype=torch.float32):
    """Six-face cube coverage: the four side angles about z, then +-90 degrees
    about x, drawn in that order."""
    views = [_cube_view(gen, a, im_res, spp, width, circle, src_type, cone_ang, False, dtype)
             for a in np.linspace(0, 360, 5)[:-1]]
    views += [_cube_view(gen, a, im_res, spp, width, circle, src_type, cone_ang, True, dtype)
              for a in (90.0, -90.0)]
    return _cat_rays(views)


def _cube_view(gen, angle, im_res, spp, width, circle, src_type, cone_ang, xaxis, dtype):
    if src_type == "plane":
        return plane_source3_rand(gen, angle, im_res, spp, width, circle=circle, xaxis=xaxis,
                                  sensor_dist=0.0, dtype=dtype)
    if src_type == "point":
        return point_source3(angle, im_res, spp, width, cone_angle=cone_ang, xaxis=xaxis,
                             sensor_dist=0.0, circle=circle, dtype=dtype, device=gen.device)
    return cone_source3_rand(gen, angle, im_res, spp, width, circle=circle, xaxis=xaxis,
                             sensor_dist=0.0, cone_angle=cone_ang, dtype=dtype)


# ---------------------------------------------------------------------------
# image norms
# ---------------------------------------------------------------------------

def sum_norm(im, scale=False):
    """Scale the image to a mean of 1; with ``scale`` also return the factor."""
    scalar = im.numel() / im.sum()
    return (scalar * im, scalar) if scale else scalar * im


def sum_norm2(im, scale=False):
    scalar = im.numel() / torch.linalg.norm(im.reshape(-1))
    return (scalar * im, scalar) if scale else scalar * im


def norm_image(im):
    """The image mapped onto [0, 1]; a constant image is returned as it is."""
    rng = im.max() - im.min()
    return torch.where(torch.isclose(rng, torch.zeros_like(rng)), im, (im - im.min()) / rng)


# ---------------------------------------------------------------------------
# 1D sensors
# ---------------------------------------------------------------------------

def tent_filter(x, r=1):
    """The tent ``max(r - x, 0)`` and its derivative (-1 inside, 0 outside)."""
    inv_dist = r - x
    dx = torch.where(inv_dist < 0, torch.zeros_like(x), -torch.ones_like(x))
    return torch.clamp(inv_dist, min=0), dx


def gauss_filter(x, r=1.0, a=0.5):
    """A Gaussian lowered by its value at ``r``, and its derivative, both 0 where
    ``|x| > 1``."""
    v = torch.exp(-a * x ** 2) - np.exp(-a * r ** 2)
    vx = -2 * a * x * torch.exp(-a * x ** 2) - np.exp(-a * r ** 2)
    mask = x.abs() > 1
    zero = torch.zeros_like(x)
    return torch.where(mask, zero, v), torch.where(mask, zero, vx)


def create_sensor(x, v, plane, nbins: int, span, e=1.0):
    """1D tent-filtered intensity histogram of 2D rays on a sensor line, with
    the analytic ``dI/dx`` parts.

    ``plane`` ``(2, 2)`` is the line's ``[origin, normal]``; each ray adds ``e``
    split between its two nearest of ``nbins`` bins across ``span``.  Returns
    ``(sensor (nbins,), (sx, sv, lo, hi))``: per ray the position and
    direction parts ``(N, 2)`` and its two bins, clamped into range.
    """
    p, n = plane[None, 0], plane[None, 1]
    t = rotate_ray(plane[None, 1], 90)
    h = span / nbins

    dp = ((x - p) * t).sum(dim=-1)
    dpn = nbins * (0.5 + dp / span) - 0.5
    vals = (e * torch.ones_like(dpn)).abs()

    dpl = torch.floor(dpn).to(torch.int64)
    dph = dpl + 1
    lm = (dpl < nbins) & (dpl >= 0)
    hm = (dph < nbins) & (dph >= 0)

    wl, wlx = tent_filter(dpn - dpl)
    wh, whx = tent_filter(dpn - dph)
    ws = wl + wh

    lo, hi = dpl.clamp(0, nbins - 1), dph.clamp(0, nbins - 1)
    zero = torch.zeros_like(dpn)
    sensor = torch.zeros(nbins, dtype=vals.dtype, device=vals.device)
    sensor = sensor.index_add(0, lo, torch.where(lm, wl * vals / ws, zero))
    sensor = sensor.index_add(0, hi, torch.where(hm, wh * vals / ws, zero))

    zero2 = torch.zeros_like(x)
    sv = torch.where(lm[:, None], wl[:, None] * n, zero2)
    sv = sv + torch.where(hm[:, None], wh[:, None] * n, zero2)
    sx = torch.where(lm[:, None], (wlx * vals)[:, None] * t / h, zero2)
    sx = sx + torch.where(hm[:, None], (whx * vals)[:, None] * t / h, zero2)
    return sensor, (sx, sv, lo, hi)


def render_intensities(x, v, planes, nviews, nrays, nbins, dim, grad=False):
    """The 1D intensity render of each of ``nviews`` views of ``nrays`` rays,
    concatenated; with ``grad`` also :func:`create_sensor`'s four ``dI/dx``
    parts, each concatenated over the views."""
    out = [create_sensor(x[i * nrays:(i + 1) * nrays], v[i * nrays:(i + 1) * nrays],
                         planes[i * nrays], nbins, dim, e=1.0 / nrays)
           for i in range(nviews)]
    ims = torch.cat([o[0] for o in out])
    if grad:
        return ims, [torch.cat(parts) for parts in zip(*[o[1] for o in out])]
    return ims
