"""Cell-table view of the trilinear field, in plain torch.

Twin of ``adjointnonlinearraytracing_tpu/fields/cells.py``.  The 8-corner
stencil of trilinear interpolation is one grid cell, so a table
``T[cz, cy, cx, 8]`` of every cell's corner values (the border clamping baked
in) turns a ray step's eight scattered reads into one 8-value row, and the
adjoint's scatter into one row add into a cell-gradient table that
:func:`fold_cell_grad` folds back onto the voxels.  That is a layout for the
TPU's row gathers; no path of the port steps on it: the kernels read the raw
grid's 8 corners (``kernels/csrc/trilinear.cuh``).  It is kept as a public
export of ``fields`` and as a second statement of the stencil's math.

Extended indexing: with ``pm = p / h`` and ``pos = floor(pm)`` the cell index
per axis is ``ci = clip(pos, -1, res-1) + 1`` in ``[0, res]``; cell ``ci`` has
the corner voxels ``clip(ci-1, 0, res-1)`` and ``clip(ci, 0, res-1)``, which is
the per-corner clamping of ``fields/grid.py`` for every position.

Corner order is (a=x, b=y, c=z) minor to major: corner = a + 2*b + 4*c.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .grid import GridField, _scalar


class CellField(NamedTuple):
    """Cell-table view of a GridField: ``table`` ``(res_z+1, res_y+1, res_x+1, 8)``."""

    table: torch.Tensor
    h: float
    res: tuple  # (res_x, res_y, res_z) voxel resolution

    @property
    def flat(self) -> torch.Tensor:
        return self.table.reshape(-1, 8)


def _clamped(n: int, device) -> torch.Tensor:
    """``clip(i - 1, 0, n - 1)`` for ``i`` in ``[0, n + 2)``: an edge pad of one."""
    return torch.clamp(torch.arange(-1, n + 1, device=device), 0, n - 1)


def build_cell_table(field: GridField) -> CellField:
    """Edge-pad the grid by one voxel, then stack the 8 shifted corner slices."""
    data = field.data  # (D, H, W)
    d, hgt, wid = data.shape
    padded = data[_clamped(d, data.device)][:, _clamped(hgt, data.device)][
        :, :, _clamped(wid, data.device)]
    corners = [padded[c:c + d + 1, b:b + hgt + 1, a:a + wid + 1]
               for c in range(2) for b in range(2) for a in range(2)]
    return CellField(torch.stack(corners, dim=-1), field.h, (wid, hgt, d))


def cell_index(cf: CellField, p: torch.Tensor):
    """Flat extended-cell index ``(N,)`` and the fractional offsets ``w0 (N, 3)``
    (outside ``[0, 1]`` off the grid, as the stencil's are)."""
    wid, hgt, d = cf.res
    pm = p / _scalar(cf.h, p)
    pos = torch.floor(pm)
    w0 = pm - pos
    top = torch.tensor([wid, hgt, d], dtype=torch.int64, device=p.device) - 1
    ci = torch.minimum(torch.maximum(pos.to(torch.int64), torch.full_like(top, -1)), top) + 1
    ci_flat = (ci[:, 2] * (hgt + 1) + ci[:, 1]) * (wid + 1) + ci[:, 0]
    return ci_flat, w0


def fetch(cf: CellField, p: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """One row read per point: ``(vals (N, 8), w0 (N, 3), ci (N,))``; a masked
    point reads zeros."""
    ci_flat, w0 = cell_index(cf, p)
    vals = cf.flat[ci_flat]
    if mask is not None:
        vals = torch.where(mask[:, None], vals, torch.zeros_like(vals))
    return vals, w0, ci_flat


def _axis_weights(w0: torch.Tensor):
    """Per axis the ``(N, 2)`` weights ``(1 - w0, w0)`` of corners 0 and 1."""
    return [torch.stack([1.0 - w0[:, k], w0[:, k]], dim=-1) for k in range(3)]


def eval_grad_from(vals: torch.Tensor, w0: torch.Tensor, h):
    """Trilinear value ``(N,)`` and gradient ``(N, 3)`` from fetched corner rows."""
    n8 = vals.reshape(-1, 2, 2, 2)  # (N, c=z, b=y, a=x)
    wx, wy, wz = _axis_weights(w0)

    vy = torch.einsum("nb,ncba->nca", wy, n8)
    vyz = torch.einsum("nc,nca->na", wz, vy)     # (N, 2) over the x corner
    n = torch.einsum("na,na->n", wx, vyz)

    inv_h = 1.0 / h
    nx = (vyz[:, 1] - vyz[:, 0]) * inv_h

    vx = torch.einsum("na,ncba->ncb", wx, n8)
    vxz = torch.einsum("nc,ncb->nb", wz, vx)
    ny = (vxz[:, 1] - vxz[:, 0]) * inv_h

    vxy = torch.einsum("nb,ncb->nc", wy, vx)
    nz = (vxy[:, 1] - vxy[:, 0]) * inv_h
    return n, torch.stack([nx, ny, nz], dim=-1)


def eval_hess_from(vals: torch.Tensor, w0: torch.Tensor, h):
    """Off-diagonal Hessian entries ``(dxdy, dxdz, dydz)`` from the same rows."""
    v = vals.reshape(-1, 2, 2, 2)  # (N, z, y, x)
    w0x, w0y, w0z = w0[:, 0], w0[:, 1], w0[:, 2]

    def lerp(a, b, t):
        return a + t * (b - a)

    dxdy = lerp(
        v[:, 0, 1, 1] - v[:, 0, 1, 0] - v[:, 0, 0, 1] + v[:, 0, 0, 0],
        v[:, 1, 1, 1] - v[:, 1, 1, 0] - v[:, 1, 0, 1] + v[:, 1, 0, 0],
        w0z,
    )
    dxdz = lerp(
        v[:, 1, 0, 1] - v[:, 1, 0, 0] - v[:, 0, 0, 1] + v[:, 0, 0, 0],
        v[:, 1, 1, 1] - v[:, 1, 1, 0] - v[:, 0, 1, 1] + v[:, 0, 1, 0],
        w0y,
    )
    dydz = lerp(
        v[:, 1, 1, 0] - v[:, 0, 1, 0] - v[:, 1, 0, 0] + v[:, 0, 0, 0],
        v[:, 1, 1, 1] - v[:, 0, 1, 1] - v[:, 1, 0, 1] + v[:, 0, 0, 1],
        w0x,
    )
    inv_h2 = 1.0 / (h * h)
    return dxdy * inv_h2, dxdz * inv_h2, dydz * inv_h2


def splat_rows(w0, val, grad, h, mask=None):
    """Per-corner contributions as ``(N, 8)`` rows: the transpose of
    :func:`eval_grad_from` with respect to the corner values."""
    n = w0.shape[0]
    wx, wy, wz = _axis_weights(w0)
    one = torch.ones(n, dtype=w0.dtype, device=w0.device)
    sgn = torch.stack([-one, one], dim=-1)

    inv_h = 1.0 / h
    gx, gy, gz = (grad[:, k] * inv_h for k in range(3))

    def at(t, axis):  # (N, 2) placed on the (N, c, b, a) axis 1 (c), 2 (b) or 3 (a)
        shape = [n, 1, 1, 1]
        shape[axis] = 2
        return t.reshape(shape)

    wzc, wyb, wxa = at(wz, 1), at(wy, 2), at(wx, 3)
    contrib = (
        val[:, None, None, None] * wzc * wyb * wxa
        + gx[:, None, None, None] * wzc * wyb * at(sgn, 3)
        + gy[:, None, None, None] * wzc * at(sgn, 2) * wxa
        + gz[:, None, None, None] * at(sgn, 1) * wyb * wxa
    ).reshape(n, 8)
    if mask is not None:
        contrib = torch.where(mask[:, None], contrib, torch.zeros_like(contrib))
    return contrib


def zero_cell_grad(cf: CellField) -> torch.Tensor:
    """A zero cell-gradient table ``(cells, 8)`` in the table's type."""
    d1, h1, w1, _ = cf.table.shape
    return torch.zeros((d1 * h1 * w1, 8), dtype=cf.table.dtype, device=cf.table.device)


def scatter_rows(cell_grad: torch.Tensor, ci_flat: torch.Tensor, contrib: torch.Tensor):
    """``cell_grad`` with one row ``contrib[i]`` added at ``ci_flat[i]`` per point
    (a new tensor)."""
    return cell_grad.index_add(0, ci_flat, contrib)


def fold_cell_grad(cell_grad: torch.Tensor, cf: CellField) -> torch.Tensor:
    """The voxel gradient ``(D, H, W)`` of a cell-gradient table: the transpose of
    :func:`build_cell_table` (each corner slice added back into an edge-padded
    accumulator, whose two outer layers then add into the boundary voxels)."""
    wid, hgt, d = cf.res
    cg = cell_grad.reshape(d + 1, hgt + 1, wid + 1, 8)
    gp = torch.zeros((d + 2, hgt + 2, wid + 2), dtype=cell_grad.dtype, device=cell_grad.device)
    k = 0
    for c in range(2):
        for b in range(2):
            for a in range(2):
                gp[c:c + d + 1, b:b + hgt + 1, a:a + wid + 1] += cg[..., k]
                k += 1
    out = gp
    for axis, n in enumerate((d, hgt, wid)):
        out = torch.zeros_like(out.narrow(axis, 0, n)).index_add_(
            axis, _clamped(n, out.device), out)
    return out
