"""RBF / multilinear scalar-field toolkit on uniform grids (n-D, n in 1..3).

Twin of ``adjointnonlinearraytracing_tpu/fields/rbf.py``: a 4^n RBF stencil
with tent or cubic-B-spline kernels for value + gradient queries and
splatting, plus 2^n multilinear get and splat.  The sensor models splat
images with its tent weights and the texture losses read with :func:`get`.

As in the JAX module:

* functional: splats return a new :class:`RbfGrid` instead of mutating;
* mask-and-zero instead of boolean compression: a masked point or an
  out-of-range stencil corner adds zero to a clipped index;
* out-of-range corners are clipped per axis.

The splats are a library scatter-add (``index_add`` on the flattened index,
atomic on the card), differentiable in the points through the tent weights
and in the values.  The JAX package computes them with XLA's scatter, outside
any Pallas kernel, so the port writes no kernel for them.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Union

import torch

_SQRT2 = 1.4142135623730951


def _clip(x, lo=None, hi=None):
    """``jnp.clip``: a maximum, then a minimum, whose gradient at a tie is
    split in half (``torch.clamp`` would pass it whole)."""
    if lo is not None:
        x = torch.maximum(x, torch.full_like(x, lo))
    if hi is not None:
        x = torch.minimum(x, torch.full_like(x, hi))
    return x


def _sqrt(sq: torch.Tensor) -> torch.Tensor:
    """``sqrt(sq)`` rounded to nearest on every device.

    The tent's kink lies exactly at ``r = sqrt(2)``, the distance of a
    diagonal stencil corner from a query on a node, so one unit in the last
    place decides that corner's gradient.  CUDA's ``sqrt`` rounds to nearest;
    torch's f64 ``sqrt`` on the CPU can come out one unit low (it gives
    ``sqrt(2.0)`` so), and is corrected here: of ``r`` and its two
    neighbours the one whose exact square (Dekker's product) lies nearest
    ``sq`` is taken, the correction carrying no gradient."""
    r = torch.sqrt(sq)
    if r.device.type != "cpu" or r.dtype != torch.float64:
        return r
    s, r0 = sq.detach(), r.detach()
    inf = torch.full_like(r0, float("inf"))
    best, best_err = r0, None
    for c in (torch.nextafter(r0, -inf), r0, torch.nextafter(r0, inf)):
        hi = c * 134217729.0  # Veltkamp split of c into 26 + 27 bits
        hi = hi - (hi - c)
        lo = c - hi
        p = c * c
        err = ((p - s) + (((hi * hi - p) + 2.0 * hi * lo) + lo * lo)).abs()
        if best_err is None:
            best_err = err
        else:
            take = err < best_err
            best = torch.where(take, c, best)
            best_err = torch.where(take, err, best_err)
    return r + (best - r0)


def rbf_tent(r):
    """Tent kernel on the stencil radius: ``(w, dw/dr, 0)``."""
    w = _clip(_SQRT2 - r, lo=0.0)
    wx = -(r < _SQRT2).to(r.dtype)
    return w, wx, 0.0


def rbf_cubic(r):
    """Cubic B-spline kernel and its derivative: ``(w, dw/dr, 0)``."""
    s = torch.sign(r)
    r = r.abs()
    m12 = (r > 1) & (r < 2)
    m1 = r <= 1
    zero = torch.zeros_like(r)
    vals = torch.where(m12, (1.0 / 6.0) * (2.0 - r) ** 3, zero)
    vx = torch.where(m12, -s * 0.5 * (2.0 - r) ** 2, zero)
    vals = torch.where(m1, (2.0 / 3.0) - r ** 2 + 0.5 * r ** 3, vals)
    vx = torch.where(m1, s * (-2.0 * r + 1.5 * r ** 2), vx)
    return vals, vx, 0.0


class RbfGrid(NamedTuple):
    """Scalar field with accumulation weights; ``scene`` is indexed
    ``[i0, i1, ...]`` where point component k indexes axis k."""

    scene: torch.Tensor
    weights: torch.Tensor
    h: Union[torch.Tensor, float]

    @staticmethod
    def create(scene: torch.Tensor, h) -> "RbfGrid":
        return RbfGrid(scene, torch.zeros_like(scene), h)

    def render(self) -> torch.Tensor:
        """``scene / weights`` where the weights are nonzero."""
        mask = ~torch.isclose(self.weights, torch.zeros_like(self.weights))
        safe = torch.where(mask, self.weights, torch.ones_like(self.weights))
        return torch.where(mask, self.scene / safe, self.scene)


def _corner_offsets(ndim: int, size: int, device) -> torch.Tensor:
    """``(size^ndim, ndim)`` corner offsets in ``itertools.product`` order."""
    return torch.tensor(list(itertools.product(range(size), repeat=ndim)),
                        dtype=torch.int64, device=device)


def _gather(scene: torch.Tensor, idx_list) -> torch.Tensor:
    """Scene values at per-axis index tensors (each ``(C, N)``), clipped."""
    capped = [ix.clamp(0, scene.shape[ax] - 1) for ax, ix in enumerate(idx_list)]
    return scene[tuple(capped)]


def _in_range(idx_list, res) -> torch.Tensor:
    """``(N, C)``: whether every axis of a stencil corner lies on the grid."""
    valid = None
    for ax, ix in enumerate(idx_list):
        ok = ((ix >= 0) & (ix < res[ax])).T
        valid = ok if valid is None else valid & ok
    return valid


def _scatter_add(grid_tensor: torch.Tensor, idx_list, values: torch.Tensor) -> torch.Tensor:
    """``grid_tensor`` plus ``values`` added at the clipped per-axis indices
    (each the shape of ``values``), out of place: a scatter-add on the
    flattened index."""
    res = grid_tensor.shape
    flat = torch.zeros_like(idx_list[0])
    for ax, ix in enumerate(idx_list):
        flat = flat * res[ax] + ix.clamp(0, res[ax] - 1)
    return grid_tensor.reshape(-1).index_add(0, flat.reshape(-1),
                                             values.reshape(-1)).reshape(res)


def _index_values(grid: RbfGrid, x: torch.Tensor):
    """The 4^n stencil around each point.

    Returns ``fi (N, C)``, ``r (N, C)``, ``dx_nm (N, C, D)`` and the per-axis
    corner indices, a list of ``(C, N)``.
    """
    ndim = x.shape[1]
    norm_x = x / grid.h - 0.5
    x1 = torch.floor(norm_x).to(torch.int64)  # (N, D)

    offsets = _corner_offsets(ndim, 4, x.device)  # (C, D)
    idx = [x1[:, d][None, :] - 1 + offsets[:, d][:, None] for d in range(ndim)]

    fi = _gather(grid.scene, idx).T  # (N, C)

    idx_stack = torch.stack(idx, dim=-1)  # (C, N, D)
    dx = (norm_x[None, :, :] - idx_stack.to(norm_x.dtype)).transpose(0, 1)  # (N, C, D)

    # NaN-safe norm: d(sqrt(s))/ds at 0 is inf and poisons the splat's
    # gradient when a query lands exactly on a grid node; guard the sqrt so
    # the value and the gradient are exactly 0 at r == 0
    sq = (dx * dx).sum(dim=-1)  # (N, C)
    zero = sq <= 0.0
    r = _sqrt(torch.where(zero, torch.ones_like(sq), sq))
    r = torch.where(zero, torch.zeros_like(r), r)
    r0 = torch.where(torch.isclose(r, torch.zeros_like(r)), torch.ones_like(r), r)
    dx_nm = dx / r0[:, :, None]
    return fi, r, dx_nm, idx


def get(grid: RbfGrid, x: torch.Tensor, sigmoid: bool = False, cubic: bool = False):
    """RBF value and gradient at the points ``x`` ``(N, D)``."""
    fi, r, dx, _ = _index_values(grid, x)
    w, wx, _ = (rbf_cubic if cubic else rbf_tent)(r)

    ws = w.sum(dim=1)
    f = torch.einsum("nc,nc->n", fi, w) / ws

    fx = torch.einsum("nc,ncd->nd", wx * fi, dx)
    fx = fx - f[:, None] * torch.einsum("nc,ncd->nd", wx, dx)
    fx = fx / ws[:, None]

    if sigmoid:
        sf = torch.sigmoid(f)
        sfx = (sf[:, None] ** 2) * torch.exp(-f)[:, None] * fx / grid.h
        return sf + 1, sfx
    return f, fx / grid.h


def get_hessian(grid: RbfGrid, x: torch.Tensor):
    """Jacobian of ``(f, fx)`` with respect to ``x`` by forward-mode autodiff:
    ``(N, N, D)`` and ``(N, D, N, D)``, as ``jax.jacfwd`` gives them."""
    return torch.func.jacfwd(lambda p: get(grid, p))(x)


def splat(grid: RbfGrid, x: torch.Tensor, f: torch.Tensor, average: bool = True,
          mask: torch.Tensor | None = None) -> RbfGrid:
    """Tent-RBF splat of per-point values.

    ``average=False`` normalizes each point's stencil weights to sum 1.
    ``mask`` ``(N,)`` optionally zeroes whole points (padded ray batches).
    """
    _, r, _, idx = _index_values(grid, x)
    w, _, _ = rbf_tent(r)  # (N, C)

    valid = _in_range(idx, grid.scene.shape)
    if mask is not None:
        valid = valid & mask[:, None]

    we = w if average else w / w.sum(dim=1, keepdim=True)
    zero = torch.zeros_like(we)
    fe = torch.where(valid, f[:, None] * we, zero)
    we = torch.where(valid, we, zero)

    idx_nc = [ix.T for ix in idx]
    return RbfGrid(_scatter_add(grid.scene, idx_nc, fe),
                   _scatter_add(grid.weights, idx_nc, we), grid.h)


def _safe_norm(fx: torch.Tensor):
    """``(|fx|, |fx| or 1 where it is ~0)`` with a gradient that is 0, not
    NaN, at ``fx == 0``."""
    sq = (fx * fx).sum(dim=-1)
    zero = sq <= 0.0
    r = torch.sqrt(torch.where(zero, torch.ones_like(sq), sq))
    r = torch.where(zero, torch.zeros_like(r), r)
    r0 = torch.where(torch.isclose(r, torch.zeros_like(r)), torch.ones_like(r), r)
    return r, r0


def splat_grad(grid: RbfGrid, x: torch.Tensor, f: torch.Tensor, fx: torch.Tensor) -> RbfGrid:
    """Value + gradient splat as three value splats, at ``x`` and ``x +- h fx/|fx|``."""
    r, r0 = _safe_norm(fx)
    dx = grid.h * (fx / r0[:, None])
    ff = grid.h * (f + r)
    fb = grid.h * (f - r)
    grid = splat(grid, x, f)
    grid = splat(grid, x + dx, ff)
    grid = splat(grid, x - dx, fb)
    return grid


def solve_grad(grid: RbfGrid, x: torch.Tensor, f: torch.Tensor, fx: torch.Tensor) -> RbfGrid:
    """Per-point least-squares fit of the stencil values to ``(f, fx)``."""
    _, r, dx, idx = _index_values(grid, x)
    w, wx, _ = rbf_tent(r)
    ws = w.sum(dim=1)

    a1 = wx[:, :, None] * dx  # (N, C, D)
    a2 = w[:, :, None] * (torch.einsum("nc,ncd->nd", wx, dx)[:, None, :] / ws[:, None, None])
    M = torch.cat([w[:, :, None], a1 - a2], dim=-1)  # (N, C, 1+D)
    M = M.transpose(1, 2) / ws[:, None, None]  # (N, 1+D, C)
    b = torch.cat([f[:, None], fx], dim=-1)  # (N, 1+D)

    # the JAX package's cutoff: 10 * max(m, n) * eps of the largest singular value
    rtol = 10 * max(M.shape[-2:]) * torch.finfo(M.dtype).eps
    Mi = torch.linalg.pinv(M, rtol=rtol)
    v = torch.einsum("nck,nk->nc", Mi, b)  # (N, C)

    valid = _in_range(idx, grid.scene.shape)
    v = torch.where(valid, v, torch.zeros_like(v))
    ones = valid.to(v.dtype)

    idx_nc = [ix.T for ix in idx]
    return RbfGrid(_scatter_add(grid.scene, idx_nc, v),
                   _scatter_add(grid.weights, idx_nc, ones), grid.h)


def _linear_stencil(grid: RbfGrid, x: torch.Tensor):
    """The 2^n stencil with clipped weights: ``norm_x``, per-axis corner
    indices ``(C, N)``, per-axis corner weights ``(C, N)`` and the offsets."""
    ndim = x.shape[1]
    norm_x = x / grid.h
    x0 = torch.floor(norm_x).to(torch.int64)
    w0 = _clip(norm_x - x0.to(norm_x.dtype), 0.0, 1.0)

    offsets = _corner_offsets(ndim, 2, x.device)  # (C, D)
    idx = [x0[:, d][None, :] + offsets[:, d][:, None] for d in range(ndim)]
    # per-corner weight along each axis: offset 0 -> 1 - w0, offset 1 -> w0
    w_ind = [torch.where(offsets[:, d][:, None] == 0, (1.0 - w0[:, d])[None, :],
                         w0[:, d][None, :]) for d in range(ndim)]
    return norm_x, idx, w_ind, offsets


def _signs(offsets: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """``(C, 1)``: -1 for the corners at offset 0 along axis ``d``, +1 otherwise."""
    lo = offsets[:, d][:, None] == 0
    return torch.where(lo, torch.tensor(-1.0, dtype=dtype, device=offsets.device),
                       torch.tensor(1.0, dtype=dtype, device=offsets.device))


def _axis_derivative_weights(offsets, w_ind, dtype):
    """Per axis d: the corner weights with axis d's weight replaced by its sign."""
    ndim = len(w_ind)
    out = []
    for d in range(ndim):
        wd = _signs(offsets, d, dtype)
        for other in range(ndim):
            if other != d:
                wd = wd * w_ind[other]
        out.append(wd)
    return out


def get_linear(grid: RbfGrid, x: torch.Tensor):
    """Multilinear value and weight-differenced gradient."""
    norm_x, idx, w_ind, offsets = _linear_stencil(grid, x)

    fi = _gather(grid.scene, idx)  # (C, N)
    wi = torch.ones_like(fi)
    for wd in w_ind:
        wi = wi * wd
    f = torch.einsum("cn,cn->n", fi, wi)

    fx = [torch.einsum("cn,cn->n", fi, wd)
          for wd in _axis_derivative_weights(offsets, w_ind, x.dtype)]
    return f, torch.stack(fx, dim=-1) / grid.h


def splat_linear(grid: RbfGrid, x: torch.Tensor, f: torch.Tensor, fx: torch.Tensor,
                 mask: torch.Tensor | None = None) -> RbfGrid:
    """Multilinear adjoint splat of value + gradient.

    A point counts where every component lies in ``[0, res[0])`` (the first
    axis's size on every axis, as in the JAX module)."""
    norm_x, idx, w_ind, offsets = _linear_stencil(grid, x)
    res = grid.scene.shape

    wp = torch.ones_like(w_ind[0])
    for wd in w_ind:
        wp = wp * wd

    dot = torch.zeros_like(wp)
    for d, wd in enumerate(_axis_derivative_weights(offsets, w_ind, x.dtype)):
        dot = dot + fx[:, d][None, :] * wd
    dot = grid.h * dot

    valid = ((norm_x >= 0) & (norm_x < res[0])).all(dim=-1)  # (N,)
    if mask is not None:
        valid = valid & mask
    zero = torch.zeros_like(wp)
    contrib = torch.where(valid[None, :], wp * f[None, :] + dot, zero)
    wcontrib = torch.where(valid[None, :], wp, zero)

    return RbfGrid(_scatter_add(grid.scene, idx, contrib),
                   _scatter_add(grid.weights, idx, wcontrib), grid.h)


def get_spline(grid: RbfGrid, x: torch.Tensor):
    """Separable cubic-B-spline value and gradient."""
    ndim = x.shape[1]
    norm_x = x / grid.h
    x0 = torch.floor(norm_x).to(torch.int64)

    offsets = _corner_offsets(ndim, 4, x.device)  # (C, D)
    idx = [x0[:, d][None, :] - 1 + offsets[:, d][:, None] for d in range(ndim)]

    # weight and derivative per axis and stencil slot s in {-1, 0, 1, 2}:
    # rbf_cubic(frac - (s - 1))
    w_ind, w_indx = [], []
    for d in range(ndim):
        t = norm_x[:, d] - x0[:, d].to(norm_x.dtype)
        slot = (offsets[:, d] - 1).to(norm_x.dtype)[:, None]  # (C, 1)
        wv, wvx, _ = rbf_cubic(t[None, :] - slot)
        w_ind.append(_clip(wv, 0.0, 1.0))
        w_indx.append(wvx)

    fi = _gather(grid.scene, idx)  # (C, N)
    wi = torch.ones_like(fi)
    for wd in w_ind:
        wi = wi * wd
    f = torch.einsum("cn,cn->n", fi, wi)

    fx = []
    for d in range(ndim):
        wd = w_indx[d]
        for other in range(ndim):
            if other != d:
                wd = wd * w_ind[other]
        fx.append(torch.einsum("cn,cn->n", fi, wd))
    return f, torch.stack(fx, dim=-1) / grid.h


def render_gradient(grid: RbfGrid, linear: bool = False) -> torch.Tensor:
    """The gradient field sampled at every grid node, ``(*res, ndim)``."""
    scene = grid.scene
    axes = [grid.h * torch.arange(r, dtype=scene.dtype, device=scene.device)
            for r in scene.shape]
    mesh = torch.meshgrid(*axes, indexing="ij")
    z = torch.stack([m.reshape(-1) for m in mesh], dim=-1)
    _, fx = get_linear(grid, z) if linear else get(grid, z)
    return fx.reshape(*scene.shape, scene.ndim)
