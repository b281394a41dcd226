"""Sensor models: plane propagation, image splatting, texture losses.

Twin of ``adjointnonlinearraytracing_tpu/sensors/sensors.py``.  The nonlinear
trace ends at the volume boundary; these helpers propagate exit rays linearly
to a sensor plane (differentiably) and splat them into 2D images with tent-RBF
weights and ``|v.n|`` foreshortening (``fields/rbf.py``), or bin far-field
directions or 4D plenoptic coordinates.  Every splat takes an optional
``mask`` so that rejected rays contribute nothing.  Everything is plain
autograd on the tensors' device; the splats are a library scatter-add.
"""

from __future__ import annotations

import torch

from ..fields import rbf


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


def get_tan_vecs(n, t=None):
    """Tangent frame ``(t1, t2)`` of a plane normal ``n`` ``(1, 3)``, each ``(1, 3)``.

    Without ``t``, ``t2`` is the x axis where ``|n_z| > 0.001`` and the z axis
    otherwise; ``t1 = n x t2``."""
    if t is None:
        pick_x = n[0, -1].abs() > 0.001
        one, zero = torch.ones_like(n[0, 0]), torch.zeros_like(n[0, 0])
        t2 = torch.zeros_like(n)
        t2[0, 0] = torch.where(pick_x, one, zero)
        t2[0, -1] = torch.where(pick_x, zero, one)
    else:
        t2 = t
    t1 = torch.linalg.cross(n, t2, dim=-1)
    return t1, t2


def _frame(n, tangent):
    """``(3, 2)``: the plane's two tangents as columns."""
    t1, t2 = get_tan_vecs(n, tangent)
    return torch.cat([t1, t2], dim=0).T


def _ang_cut(angle_span, like: torch.Tensor) -> torch.Tensor:
    """``sin(angle_span / 2)`` (degrees) in ``like``'s dtype."""
    span = torch.as_tensor(angle_span, dtype=like.dtype, device=like.device)
    return torch.sin(0.5 * torch.deg2rad(span))


def _per_ray(e, like: torch.Tensor, n: int) -> torch.Tensor:
    """Emission ``e`` (a scalar or ``(N,)``) as ``(N,)`` in ``like``'s dtype."""
    return torch.broadcast_to(torch.as_tensor(e, dtype=like.dtype, device=like.device), (n,))


def generate_sensor(rays, e, plane, res: int, span, tangent=None, mask=None):
    """Near-plane sensor image: a tent-RBF splat with foreshortening.

    ``e`` is the per-ray emission (a scalar or ``(N,)``).  Returns the
    ``(res, res)`` image."""
    x, v = trace_rays_to_plane(rays, plane)
    p, n = plane

    T = _frame(n, tangent)  # (3, 2)
    h = span / res
    sensor = rbf.RbfGrid.create(torch.zeros((res, res), dtype=x.dtype, device=x.device), h)

    fs = (v * torch.broadcast_to(n, v.shape)).sum(dim=-1).abs()
    xn = (x - p) @ T + span / 2

    e = _per_ray(e, x, fs.shape[0])
    return rbf.splat(sensor, xn, fs * e, average=False, mask=mask).scene


def generate_inf_sensor(rays, e, plane, res: int, angle_span=120, tangent=None, mask=None):
    """Far-field sensor: the directions binned in sin-angle coordinates."""
    x, v = rays
    p, n = plane

    v_norm = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    ang_cut = _ang_cut(angle_span, x)

    T = _frame(n, tangent)
    sensor = rbf.RbfGrid.create(torch.zeros((res, res), dtype=x.dtype, device=x.device),
                                2 * ang_cut / res)
    vn = v_norm @ T + ang_cut
    fe = _per_ray(e, x, x.shape[0])
    return rbf.splat(sensor, vn, fe, average=False, mask=mask).scene


def generate_pleno_sensor(rays, e, plane, bins, span, angle_span=120, tangent=None,
                          mask=None):
    """4D (position x direction) plenoptic binning, ``bins`` = ``(bx, by, bu, bv)``."""
    x, v = trace_rays_to_plane(rays, plane)
    p, n = plane

    h = span / bins[0]
    ang_cut = _ang_cut(angle_span, x)

    t1, t2 = get_tan_vecs(n, tangent)
    Tx = torch.cat([t1, t2], dim=0).T
    Tv = torch.cat([t1, -t2], dim=0).T

    xgrid = rbf.RbfGrid.create(torch.zeros((bins[0], bins[1]), dtype=x.dtype,
                                           device=x.device), h)
    vgrid = rbf.RbfGrid.create(torch.zeros((bins[2], bins[3]), dtype=x.dtype,
                                           device=x.device), 2 * ang_cut / bins[2])

    xn = (x - p) @ Tx + span / 2
    vn = v @ Tv + ang_cut

    _, rx, _, xidx = rbf._index_values(xgrid, xn)
    _, rv, _, vidx = rbf._index_values(vgrid, vn)

    # validity from the position stencil only; each of its axes against bins[0]
    xvalid = rbf._in_range(xidx, (bins[0], bins[0]))
    if mask is not None:
        xvalid = xvalid & mask[:, None]

    wx, _, _ = rbf.rbf_tent(rx)
    wv, _, _ = rbf.rbf_tent(rv)
    wxe = wx / wx.sum(dim=1, keepdim=True)
    wve = wv / wv.sum(dim=1, keepdim=True)

    fs = (v * torch.broadcast_to(n, v.shape)).sum(dim=-1).abs()
    fe = _per_ray(e, x, fs.shape[0]) * fs

    # corner c of the position stencil is paired with corner c of the
    # direction stencil: a diagonal deposit, not the outer product
    contrib = torch.where(xvalid, wxe * wve * fe[:, None], torch.zeros_like(wxe))  # (N, C)

    lim = (bins[0], bins[0], bins[2], bins[2])
    cols = [ix.T.clamp(0, lim[k] - 1) for k, ix in enumerate([*xidx, *vidx])]
    pleno = torch.zeros(tuple(bins), dtype=x.dtype, device=x.device)
    return rbf._scatter_add(pleno, cols, contrib)


def _tex_coords(rays, plane, span, tangent):
    """The plane-hit positions in the texture's coordinates ``[0, span)^2``."""
    x, _ = trace_rays_to_plane(rays, plane)
    p, n = plane
    return (x - p) @ _frame(n, tangent) + span / 2


def get_sdf_vals_near(rays, d_tex, plane, span, tangent=None):
    """A distance texture ``(res, res)`` sampled at the plane-hit position."""
    xn = _tex_coords(rays, plane, span, tangent)
    x_grid = rbf.RbfGrid.create(d_tex, span / d_tex.shape[0])
    return rbf.get(x_grid, xn)[0]


def get_sdf_vals_far(rays, d_tex, plane, ang_span, tangent=None):
    """A deflection texture ``(res, res)`` sampled at the exit direction."""
    x, v = trace_rays_to_plane(rays, plane)
    p, n = plane
    ang_cut = _ang_cut(ang_span, x)
    x_grid = rbf.RbfGrid.create(d_tex, 2 * ang_cut / d_tex.shape[0])
    vn = v @ _frame(n, tangent) + ang_cut
    return rbf.get(x_grid, vn)[0]


def get_disps_from_tex(rays, d_tex, plane, span, tangent=None):
    """Per-ray target position on the plane from a 2-channel texture ``(res, res, 2)``."""
    p, n = plane
    h = span / d_tex.shape[0]
    T = _frame(n, tangent)
    xn = _tex_coords(rays, plane, span, tangent)
    disp_x, _ = rbf.get(rbf.RbfGrid.create(d_tex[..., 0], h), xn)
    disp_y, _ = rbf.get(rbf.RbfGrid.create(d_tex[..., 1], h), xn)
    disps = torch.stack([disp_x, disp_y], dim=-1) - span / 2
    return disps @ T.T + p


def get_defls_from_tex(rays, d_tex, plane, span, tangent=None):
    """Per-ray target direction from a 2-channel texture ``(res, res, 2)``."""
    p, n = plane
    h = span / d_tex.shape[0]
    t, t2 = get_tan_vecs(n, tangent)
    xn = _tex_coords(rays, plane, span, tangent)
    defl_x = 2 * (rbf.get(rbf.RbfGrid.create(d_tex[..., 0], h), xn)[0] - 0.5)
    defl_y = 2 * (rbf.get(rbf.RbfGrid.create(d_tex[..., 1], h), xn)[0] - 0.5)
    defl_z = 1 - defl_x ** 2 - defl_y ** 2
    defls = torch.stack([defl_x, defl_y, defl_z], dim=-1)
    frame = torch.cat([t, t2, n], dim=0).T  # (3, 3)
    return defls @ frame.T


def refract(rays, plane, etai, etae=1.0):
    """Snell's-law refraction at the plane; ``v`` is zero where ``k < 1``, as in
    the JAX module."""
    x, v = rays
    _, n = plane
    n = torch.broadcast_to(n, v.shape)
    cosi = (v * n).sum(dim=-1)
    eta = etai / etae
    k = 1 - eta ** 2 * (1 - cosi ** 2)
    refr = eta * v + (eta * cosi[:, None] - torch.sqrt(rbf._clip(k, lo=0.0))[:, None]) \
        * torch.sign(cosi)[:, None] * n
    vout = torch.where((k >= 1)[:, None], refr, torch.zeros_like(refr))
    return x, vout

