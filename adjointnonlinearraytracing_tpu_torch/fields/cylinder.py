"""Cylinder (radial-profile) refractive-index field (PyTorch).

Twin of ``adjointnonlinearraytracing_tpu/fields/cylinder.py``: a 1D radial
profile ``data[r]`` embedded in a cylinder whose axis is y, centred at
``x = z = radius``, with radial spacing ``h = radius / (res - 1)``.

* ``cyl_eval_grad``: 1D lerp along ``r = |(x, 0, z) - (radius, 0, radius)|``
  with the gradient along the radial unit vector, zeroed within ``r < 1e-6``.
* ``cyl_eval_hess``: ``(rx/r) (I - xhat xhat^T)`` on the xz-plane.
* ``cyl_splat_delta``: the exact transpose of ``cyl_eval_grad``: the value's
  lerp weights plus the ``-/+ (g . xhat) / h`` gradient pair (the 1/h is on
  the gradient part, as for the voxel grid's splat).
* ``cyl_inbounds`` / ``cyl_escaped``: cylindrical bounds, and outside and
  moving away.

Both indices are clamped to ``[0, res-1]`` (``idx1 = clamp(idx0 + 1)``) and
the weight is taken against the clamped ``idx0``, so a point past the last
bin extrapolates along it as the JAX module does.

Everything here is plain, dtype-polymorphic torch and runs where its tensors
live; it is the plain version of the cable kernels' field code
(``kernels/csrc/cylinder.cuh``), which repeats it operation by operation
without FMA contraction.  So the sums of squares are written out in a fixed
order, ``r`` is ``sqrt(dx*dx + dz*dz)``, and every division by ``h`` is a
true division by a 0-dim tensor (dividing a CUDA tensor by a Python scalar
multiplies by the reciprocal).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .grid import _scalar, upres_volume

_EPS = 1e-6


class CylinderField(NamedTuple):
    """A radial profile ``data`` (res,) in a cylinder of ``radius`` and ``length``."""

    data: torch.Tensor
    radius: float
    length: float

    @property
    def h(self) -> float:
        return self.radius / (self.data.shape[0] - 1)


def _radial(field: CylinderField, p: torch.Tensor):
    """Radial set-up: ``(xs, r, h, idx0, idx1, w0, w1)``; ``xs`` is ``p - radius``
    with its y component zeroed, ``h`` a 0-dim tensor of ``p``'s dtype."""
    res = field.data.shape[0]
    xs = p - _scalar(field.radius, p)
    xs = torch.stack([xs[:, 0], torch.zeros_like(xs[:, 0]), xs[:, 2]], dim=-1)
    r = torch.sqrt(xs[:, 0] * xs[:, 0] + xs[:, 2] * xs[:, 2])
    h = _scalar(field.radius / (res - 1), p)
    rm = r / h
    idx0 = torch.clamp(torch.floor(rm).to(torch.int64), 0, res - 1)
    idx1 = torch.clamp(idx0 + 1, 0, res - 1)
    w0 = rm - idx0.to(rm.dtype)
    w1 = 1.0 - w0
    return xs, r, h, idx0, idx1, w0, w1


def _small(r: torch.Tensor) -> torch.Tensor:
    return r < _scalar(_EPS, r)


def _safe_unit(xs: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``xs / r`` with the ``r ~ 0`` singularity mapped to 0."""
    small = _small(r)
    rsafe = torch.where(small, torch.ones_like(r), r)
    xhat = xs / rsafe[:, None]
    return torch.where(small[:, None], torch.zeros_like(xhat), xhat)


def cyl_eval_grad(field: CylinderField, p: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """1D radial lerp value and its gradient along the radial direction.

    Unmasked the profile is read at every point, as the JAX function does;
    ``mask`` zeroes the outputs of the lanes it leaves out.  Returns
    ``(n (N,), grad (N, 3))``.
    """
    xs, r, h, idx0, idx1, w0, w1 = _radial(field, p)
    val0 = field.data[idx0]
    val1 = field.data[idx1]
    f = val0 * w1 + val1 * w0
    rx = (val1 - val0) / h
    fx = rx[:, None] * _safe_unit(xs, r)
    if mask is not None:
        f = torch.where(mask, f, torch.zeros_like(f))
        fx = torch.where(mask[:, None], fx, torch.zeros_like(fx))
    return f, fx


def cyl_eval_hess(field: CylinderField, p: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """Hessian ``(rx/r)(I - xhat xhat^T)`` on the xz-plane, zero near the axis.

    Returned packed as ``(hxx, hxz, hzz)``; the y row and column are zero.
    Apply it with :func:`cyl_hess_matvec`.
    """
    xs, r, h, idx0, idx1, w0, w1 = _radial(field, p)
    rx = (field.data[idx1] - field.data[idx0]) / h
    xhat = _safe_unit(xs, r)
    small = _small(r)
    rsafe = torch.where(small, torch.ones_like(r), r)
    scale = torch.where(small, torch.zeros_like(r), rx / rsafe)
    hxx = scale * (1.0 - xhat[:, 0] * xhat[:, 0])
    hxz = scale * (-(xhat[:, 0] * xhat[:, 2]))
    hzz = scale * (1.0 - xhat[:, 2] * xhat[:, 2])
    if mask is not None:
        zero = torch.zeros_like(hxx)
        hxx, hxz, hzz = (torch.where(mask, t, zero) for t in (hxx, hxz, hzz))
    return hxx, hxz, hzz


def cyl_hess_matvec(hess, mu: torch.Tensor) -> torch.Tensor:
    hxx, hxz, hzz = hess
    return torch.stack([hxx * mu[:, 0] + hxz * mu[:, 2], torch.zeros_like(hxx),
                        hxz * mu[:, 0] + hzz * mu[:, 2]], dim=-1)


def _splat_terms(field: CylinderField, p, val, grad, mask):
    """The two bins and their terms: ``val * w + / - (grad . xhat) / h``."""
    xs, r, h, idx0, idx1, w0, w1 = _radial(field, p)
    xhat = _safe_unit(xs, r)
    grad_val = (grad[:, 0] * xhat[:, 0] + grad[:, 1] * xhat[:, 1]) + grad[:, 2] * xhat[:, 2]
    grad_val = torch.where(_small(r), torch.zeros_like(grad_val), grad_val)
    c0 = val * w1 - grad_val / h
    c1 = val * w0 + grad_val / h
    if mask is not None:
        c0 = torch.where(mask, c0, torch.zeros_like(c0))
        c1 = torch.where(mask, c1, torch.zeros_like(c1))
    return idx0, idx1, c0, c1


def cyl_scatter_into(acc: torch.Tensor, field: CylinderField, p, val, grad,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add the splat of ``(val, grad)`` at ``p`` into ``acc`` (res,) **in place**.

    The terms are computed in ``p``'s type and added in ``acc``'s (float64
    sums float32 terms as a reference)."""
    idx0, idx1, c0, c1 = _splat_terms(field, p, val, grad, mask)
    acc.index_add_(0, idx0, c0.to(acc.dtype))
    return acc.index_add_(0, idx1, c1.to(acc.dtype))


def cyl_splat_delta(field: CylinderField, p, val, grad,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Radial-profile delta of splatting ``(val, grad)`` at ``p``; transpose of
    :func:`cyl_eval_grad`: ``<delta, u> == val * n_u(p) + grad . grad_u(p)``."""
    return cyl_scatter_into(torch.zeros_like(field.data), field, p, val, grad, mask)


def cyl_inbounds(field: CylinderField, p: torch.Tensor) -> torch.Tensor:
    pl = p - _scalar(field.radius, p)
    r2 = pl[:, 0] * pl[:, 0] + pl[:, 2] * pl[:, 2]
    inlength = (p[:, 1] < _scalar(field.length, p)) & (p[:, 1] >= 0)
    return (r2 < _scalar(field.radius ** 2, p)) & inlength


def cyl_escaped(field: CylinderField, p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Outside and moving away: past a cap along y, or outside the radius and
    receding from the axis."""
    pl = p - _scalar(field.radius, p)
    length = _scalar(field.length, p)
    esc_length = ((p[:, 1] < 0) & (v[:, 1] < 0)) | ((p[:, 1] > length) & (v[:, 1] > 0))
    out_radius = (pl[:, 0] * pl[:, 0] + pl[:, 2] * pl[:, 2]) >= _scalar(field.radius ** 2, p)
    esc_radius = (pl[:, 0] * v[:, 0] + pl[:, 2] * v[:, 2]) > 0
    return (out_radius & esc_radius) | esc_length


def upres_profile(n: torch.Tensor, new_res: int) -> torch.Tensor:
    """Linear resample of a 1D radial profile onto ``new_res`` points."""
    return upres_volume(n, (new_res,))


def upres_profile_midpoint(n: torch.Tensor) -> torch.Tensor:
    """Midpoint-insertion upsampling to ``2*(res-1)+1`` points: even slots keep
    the old samples, odd slots get the neighbours' midpoints."""
    out = torch.zeros(((n.shape[0] - 1) * 2 + 1,), dtype=n.dtype, device=n.device)
    out[::2] = n
    out[1::2] = (n[1:] + n[:-1]) / 2
    return out


def cyl_render(field: CylinderField, res):
    """The profile sampled onto a 3D voxel image over the cylinder's box."""
    dev, dt = field.data.device, field.data.dtype
    rx = torch.linspace(0.0, 2 * field.radius, res[0], dtype=dt, device=dev)
    ry = torch.linspace(0.0, field.length, res[1], dtype=dt, device=dev)
    rz = torch.linspace(0.0, 2 * field.radius, res[2], dtype=dt, device=dev)
    mesh = torch.meshgrid(rx, ry, rz, indexing="ij")
    pos = torch.stack([m.reshape(-1) for m in mesh], dim=-1)
    n, _ = cyl_eval_grad(field, pos)
    return n.reshape(tuple(res))


def cyl_render2(field: CylinderField, res):
    """Axial 2D slice through the cylinder's centre (the plane z = radius)."""
    if isinstance(res, int):
        res = (res, res)
    dev, dt = field.data.device, field.data.dtype
    rx = torch.linspace(0.0, 2 * field.radius, res[0], dtype=dt, device=dev)
    ry = torch.linspace(0.0, field.length, res[1], dtype=dt, device=dev)
    gx, gy = torch.meshgrid(rx, ry, indexing="ij")
    pos = torch.stack([gx.reshape(-1), gy.reshape(-1),
                       torch.full((res[0] * res[1],), float(field.radius), dtype=dt,
                                  device=dev)], dim=-1)
    n, _ = cyl_eval_grad(field, pos)
    return n.reshape(tuple(res))
