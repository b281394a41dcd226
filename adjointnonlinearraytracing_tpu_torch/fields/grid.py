"""Regular-grid scalar field on a uniform voxel lattice (PyTorch).

Twin of ``adjointnonlinearraytracing_tpu/fields/grid.py``; same semantics:

* The field lives on ``[0, (res-1)*h]^3``; voxel spacing ``h``.
* ``eval_grad`` is trilinear interpolation with the analytic gradient obtained
  by differencing the interpolation weights.
* ``eval_hess`` is the off-diagonal-only trilinear Hessian (the diagonal of a
  trilinear interpolant is identically zero).
* ``splat_delta`` / ``scatter_into`` are the exact transpose of ``eval_grad``
  with respect to the voxel data, including the ``1/h`` on the gradient part.
* Out-of-range stencil indices are clamped to the border per corner; a
  masked-out lane gathers 0 and so contributes ``(0, 0)``.
* Data layout: ``data[z, y, x]`` with ``p = (x, y, z)``; the flat index is
  ``(z*H + y)*W + x``.
* ``upres_volume`` resamples a volume onto a finer (or coarser) lattice; the
  multi-resolution optimiser uses it between stages.

Everything here is plain, dtype-polymorphic torch (f32 and f64) and runs where
its tensors live.  The one exception is :func:`eval_grad`, which hands CUDA
tensors to the hand-written kernel ``kernels/csrc/eval_grad.cu``;
:func:`eval_grad_plain` is that kernel's plain version and the one the plain
steppers in ``tracer/eikonal.py`` call.

The arithmetic is written out operation by operation (no ``einsum``, no fused
``lerp``/``addcmul``) because the CUDA kernels repeat it in the same order
without FMA contraction: positions that sit exactly on a node or a face must
take the same ``floor``/``inbounds`` decision in both.  For the same reason
``p / h`` is a true division by a 0-dim tensor: dividing a CUDA tensor by a
Python scalar multiplies by the reciprocal, which flips ``floor`` at nodes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels import wrappers as _K


class GridField(NamedTuple):
    """A scalar voxel field: ``data[z, y, x]`` with spacing ``h``.

    ``data`` may be f32 or f64; ``h`` is a Python float.  The physical extent
    per axis is ``(res_axis - 1) * h``.
    """

    data: torch.Tensor  # (D, H, W) = (res_z, res_y, res_x)
    h: float

    @property
    def res(self) -> Tuple[int, int, int]:
        d, hh, w = self.data.shape
        return (w, hh, d)  # (res_x, res_y, res_z)

    @staticmethod
    def from_flat(flat: torch.Tensor, res: Tuple[int, int, int], h: float) -> "GridField":
        """Build from a flat buffer with the flat-index convention above."""
        w, hh, d = res
        return GridField(flat.reshape(d, hh, w), h)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim tensor of ``like``'s dtype on ``like``'s device."""
    return torch.full((), float(value), dtype=like.dtype, device=like.device)


def _hi(field: GridField, p: torch.Tensor) -> torch.Tensor:
    """Upper face per axis, ``(res - 1) * h`` computed in ``p``'s dtype."""
    d, hgt, wid = field.data.shape
    res = torch.tensor([wid, hgt, d], dtype=p.dtype, device=p.device)
    return (res - 1) * _scalar(field.h, p)


def _stencil(field: GridField, p: torch.Tensor):
    """Common 8-corner stencil setup.

    Returns ``(flat_idx (2,2,2,N), wx, wy, wz each (2,N))`` where index a in
    the first axis selects the x-corner, b the y-corner, c the z-corner and
    the weight stacks are ordered ``(w1, w0)`` so that ``w[a]`` is the weight
    of corner a (corner 0 gets ``1 - frac``).
    """
    d, hgt, wid = field.data.shape
    res = torch.tensor([wid, hgt, d], dtype=torch.int64, device=p.device)

    pm = p / _scalar(field.h, p)
    posf = torch.floor(pm)
    w0 = pm - posf  # fractional offset (may leave [0,1] off-grid)
    w1 = 1.0 - w0
    pos = posf.to(torch.int64)
    zero = torch.zeros_like(res)
    pos0 = torch.minimum(torch.maximum(pos, zero), res - 1)
    pos1 = torch.minimum(torch.maximum(pos + 1, zero), res - 1)

    cx = torch.stack([pos0[:, 0], pos1[:, 0]])
    cy = torch.stack([pos0[:, 1], pos1[:, 1]])
    cz = torch.stack([pos0[:, 2], pos1[:, 2]])

    idx = (cz[None, None, :, :] * hgt + cy[None, :, None, :]) * wid + cx[:, None, None, :]

    wx = torch.stack([w1[:, 0], w0[:, 0]])
    wy = torch.stack([w1[:, 1], w0[:, 1]])
    wz = torch.stack([w1[:, 2], w0[:, 2]])
    return idx, wx, wy, wz


def _corner_values(field: GridField, idx: torch.Tensor, mask: Optional[torch.Tensor]):
    v = field.data.reshape(-1)[idx]  # (a=x, b=y, c=z, N)
    if mask is not None:
        v = torch.where(mask[None, None, None, :], v, torch.zeros_like(v))
    return v


def eval_grad_plain(field: GridField, p: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """Trilinear value + analytic gradient at points ``p`` (N, 3), plain torch.

    Masked-out lanes gather 0, yielding ``(0, 0)`` so a masked ray drifts in a
    straight line in the stepper.  Returns ``(n (N,), grad (N, 3))``; grad
    includes the ``1/h`` factor.
    """
    idx, wx, wy, wz = _stencil(field, p)
    return value_grad_from(_corner_values(field, idx, mask), wx, wy, wz, field.h)


def value_grad_from(v: torch.Tensor, wx, wy, wz, h: float):
    """:func:`eval_grad_plain`'s arithmetic on corner values ``v`` ``(2, 2, 2, N)``
    (a=x, b=y, c=z) and the weights of :func:`_stencil`."""
    inv_h = 1.0 / h

    vy = wy[0] * v[:, 0] + wy[1] * v[:, 1]          # contract y -> (a, c, N)
    vyz = wz[0] * vy[:, 0] + wz[1] * vy[:, 1]       # contract z -> (a, N)
    n = wx[0] * vyz[0] + wx[1] * vyz[1]
    nx = (vyz[1] - vyz[0]) * inv_h

    vx = wx[0] * v[0] + wx[1] * v[1]                # contract x -> (b, c, N)
    vxz = wz[0] * vx[:, 0] + wz[1] * vx[:, 1]       # contract z -> (b, N)
    ny = (vxz[1] - vxz[0]) * inv_h

    vxy = wy[0] * vx[0] + wy[1] * vx[1]             # contract y -> (c, N)
    nz = (vxy[1] - vxy[0]) * inv_h

    return n, torch.stack([nx, ny, nz], dim=-1)


def eval_grad(field: GridField, p: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """Trilinear value + gradient; the CUDA kernel for CUDA tensors.

    Same contract as :func:`eval_grad_plain`, which is what CPU tensors get.
    """
    if p.is_cuda:
        return _K.eval_grad(field.data, field.h, p, mask)
    return eval_grad_plain(field, p, mask)


def eval_hess(field: GridField, p: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """Off-diagonal trilinear Hessian entries ``(dxdy, dxdz, dydz)``.

    Includes the ``1/h^2`` scale.  Use :func:`hess_matvec` to apply ``H @ mu``.
    """
    idx, wx, wy, wz = _stencil(field, p)
    return hess_from(_corner_values(field, idx, mask), wx, wy, wz, field.h)


def hess_from(v: torch.Tensor, wx, wy, wz, h: float):
    """:func:`eval_hess`'s arithmetic on corner values ``v`` and weights, as
    :func:`value_grad_from`."""
    w0x, w0y, w0z = wx[1], wy[1], wz[1]

    def lerp(a, b, t):
        return a + t * (b - a)

    dxdy = lerp(
        v[1, 1, 0] - v[0, 1, 0] - v[1, 0, 0] + v[0, 0, 0],
        v[1, 1, 1] - v[0, 1, 1] - v[1, 0, 1] + v[0, 0, 1],
        w0z,
    )
    dxdz = lerp(
        v[1, 0, 1] - v[0, 0, 1] - v[1, 0, 0] + v[0, 0, 0],
        v[1, 1, 1] - v[0, 1, 1] - v[1, 1, 0] + v[0, 1, 0],
        w0y,
    )
    dydz = lerp(
        v[0, 1, 1] - v[0, 0, 1] - v[0, 1, 0] + v[0, 0, 0],
        v[1, 1, 1] - v[1, 0, 1] - v[1, 1, 0] + v[1, 0, 0],
        w0x,
    )
    inv_h2 = 1.0 / (h * h)
    return dxdy * inv_h2, dxdz * inv_h2, dydz * inv_h2


def hess_matvec(hess, mu: torch.Tensor) -> torch.Tensor:
    """Apply the symmetric zero-diagonal Hessian to vectors ``mu`` (N, 3)."""
    dxdy, dxdz, dydz = hess
    return torch.stack(
        [
            dxdy * mu[:, 1] + dxdz * mu[:, 2],
            dxdy * mu[:, 0] + dydz * mu[:, 2],
            dxdz * mu[:, 0] + dydz * mu[:, 1],
        ],
        dim=-1,
    )


def _splat_corner_values(field: GridField, p, val, grad, mask):
    """Per-corner scatter contributions for the transpose of eval_grad."""
    idx, wx, wy, wz = _stencil(field, p)
    inv_h = 1.0 / field.h

    # value part: val * wx[a] wy[b] wz[c]
    # grad part:  the sign (-1 for corner 0, +1 for corner 1) replaces the
    # weight of the differentiated axis
    one = torch.ones_like(wx[0])
    sgn = torch.stack([-one, one])  # (2, N)
    gx = grad[:, 0] * inv_h
    gy = grad[:, 1] * inv_h
    gz = grad[:, 2] * inv_h

    wxa, sxa = wx[:, None, None, :], sgn[:, None, None, :]
    wyb, syb = wy[None, :, None, :], sgn[None, :, None, :]
    wzc, szc = wz[None, None, :, :], sgn[None, None, :, :]
    contrib = (
        val * wxa * wyb * wzc
        + gx * sxa * wyb * wzc
        + gy * wxa * syb * wzc
        + gz * wxa * wyb * szc
    )
    if mask is not None:
        contrib = torch.where(mask[None, None, None, :], contrib, torch.zeros_like(contrib))
    return idx, contrib


def splat_delta(field: GridField, p, val, grad, mask=None) -> torch.Tensor:
    """Return the flat voxel-space delta of splatting ``(val, grad)`` at ``p``.

    Exact transpose of ``eval_grad``: for any voxel buffer u,
    ``<splat_delta(p, val, grad), u> == val * n_u(p) + grad . grad_u(p)``.
    """
    out = torch.zeros((field.data.numel(),), dtype=field.data.dtype, device=field.data.device)
    return scatter_into(out, field, p, val, grad, mask)


def splat(field: GridField, p, val, grad, mask=None) -> GridField:
    """A new field: ``field`` plus :func:`splat_delta` of ``(val, grad)`` at ``p``."""
    delta = splat_delta(field, p, val, grad, mask)
    return GridField(field.data + delta.reshape(field.data.shape), field.h)


def scatter_into(acc_flat: torch.Tensor, field: GridField, p, val, grad, mask=None) -> torch.Tensor:
    """Accumulate splat contributions into ``acc_flat`` **in place**; returns it.

    The contributions are computed in ``p``'s type and added in ``acc_flat``'s.
    """
    idx, contrib = _splat_corner_values(field, p, val, grad, mask)
    return acc_flat.index_add_(0, idx.reshape(-1), contrib.reshape(-1).to(acc_flat.dtype))


def inbounds(field: GridField, p: torch.Tensor) -> torch.Tensor:
    """p inside ``[0, (res-1)*h)`` per axis."""
    return ((p >= 0) & (p < _hi(field, p))).all(dim=-1)


def escaped(field: GridField, p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Outside the grid AND moving away, on any axis."""
    esc = ((p < 0) & (v < 0)) | ((p >= _hi(field, p)) & (v > 0))
    return esc.any(dim=-1)


def snap_tol(dtype: torch.dtype) -> float:
    """Default snap tolerance in cells: 1e-9 (f64), 1e-3 (f32)."""
    return 1e-9 if dtype == torch.float64 else 1e-3


def snap_to_nodes(p: torch.Tensor, h: float, tol: Optional[float] = None) -> torch.Tensor:
    """Snap coordinates lying within ``tol`` cells of a grid node onto it.

    Used by the adjoint reverse sweep: re-integrated positions drift by
    O(eps) per step, and a forward position that lay *exactly* on a cell
    boundary can be reconstructed at -eps, flipping ``inbounds``/``escaped``
    and silently dropping that step's gradient contribution.  Snapping
    restores the forward's cell assignment and masks; genuine positions move
    by at most ``tol*h``.
    """
    ht = _scalar(h, p)
    pm = p / ht
    if tol is None:
        tol = snap_tol(pm.dtype)
    r = torch.round(pm)
    pm = torch.where((pm - r).abs() <= tol, r, pm)
    return pm * ht


def upres_volume(n: torch.Tensor, new_res) -> torch.Tensor:
    """Trilinearly resample a cubic volume to ``new_res`` per axis; 1D, 2D or 3D.

    The source grid is placed on ``[0, 1]^ndim`` with spacing
    ``1 / (res - 1)`` and sampled at ``linspace(0, 1, new_res)`` per axis,
    with both corners clamped per axis.  Plain torch in ``n``'s dtype on
    ``n``'s device: it runs once per resolution change, not per step.
    """
    if isinstance(new_res, int):
        new_res = (new_res,) * n.ndim
    new_res = tuple(int(r) for r in new_res)
    h = 1.0 / max(n.shape[0] - 1, 1)

    axes = [torch.linspace(0.0, 1.0, r, dtype=n.dtype, device=n.device) for r in new_res]
    mesh = torch.meshgrid(*axes, indexing="ij")
    pts = torch.stack([m.reshape(-1) for m in mesh], dim=-1)  # (N, ndim)

    pm = pts / h
    posf = torch.floor(pm)
    frac = pm - posf
    pos = posf.to(torch.int64)
    top = torch.tensor(n.shape, dtype=torch.int64, device=n.device) - 1
    zero = torch.zeros_like(top)
    pos0 = torch.minimum(torch.maximum(pos, zero), top)
    pos1 = torch.minimum(torch.maximum(pos + 1, zero), top)

    flat = n.reshape(-1)
    strides = [1] * n.ndim  # of the C-order flat index
    for ax in range(n.ndim - 2, -1, -1):
        strides[ax] = strides[ax + 1] * n.shape[ax + 1]

    out = torch.zeros((pts.shape[0],), dtype=n.dtype, device=n.device)
    for corner in range(2 ** n.ndim):
        idx = torch.zeros((pts.shape[0],), dtype=torch.int64, device=n.device)
        w = torch.ones((pts.shape[0],), dtype=n.dtype, device=n.device)
        for ax in range(n.ndim):
            upper = (corner >> (n.ndim - 1 - ax)) & 1
            idx = idx + (pos1 if upper else pos0)[:, ax] * strides[ax]
            w = w * (frac[:, ax] if upper else 1.0 - frac[:, ax])
        out = out + w * flat[idx]
    return out.reshape(new_res)
