"""A ray order in which neighbouring rays walk through neighbouring cells.

``tracer.api.trace`` hands the steppers K2 and K3 (``kernels/csrc/trace_fwd.cu``,
``kernels/csrc/backtrace.cu``) a permutation of the rays: thread ``i`` works on
ray ``order[i]``.  The rays of a warp then read the same or neighbouring
corners at every step, and the adjoint's splats of a warp land on the same or
neighbouring words, instead of 32 unrelated cells where the caller's rays come
in random order (the bench scene draws its entry points at random).  The
outputs stay in the caller's order: the kernels read and write ray
``order[i]``.

The key of a ray, high bits to low:

* the dominant axis of its direction and that component's sign (3 bits);
* the Morton (Z-order) code of the cell where its line first meets the grid
  box ``[0, (res-1)*h]^3`` (a slab intersection; a ray that starts inside
  uses its start cell, a line that misses the box its start position clamped
  to the box), 9 bits an axis, so the key is an int32.

``torch.argsort`` with ``stable=True`` breaks ties by the caller's order, so
the permutation is a pure function of the inputs.  This is plain tensor code
that runs where its tensors live; it is set-up around the kernels, not a
kernel, and it is written in few operations because each is a launch.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

MORTON_BITS = 9  # per axis, so that a key fits in int32; cells are scaled where res > 513


def _spread_bits(c: torch.Tensor) -> torch.Tensor:
    """The low 10 bits of ``c`` (int64) moved to every third bit."""
    c = c & 0x3FF
    c = (c | (c << 16)) & 0x030000FF
    c = (c | (c << 8)) & 0x0300F00F
    c = (c | (c << 4)) & 0x030C30C3
    c = (c | (c << 2)) & 0x09249249
    return c


@functools.lru_cache(maxsize=32)
def _constants(device: torch.device, dtype: torch.dtype, shape: Tuple[int, int, int], h: float):
    """The box's upper faces ``(x, y, z)`` and the Morton table, on ``device`` (made once:
    a copy to the card waits for it, so it is not made on every call).  Row ``k``
    of the table holds the spread bits of every cell index shifted to axis
    ``k``'s place, so that a cell's code is the sum of three entries."""
    d, hgt, wid = shape
    hi = torch.tensor([(wid - 1) * h, (hgt - 1) * h, (d - 1) * h], dtype=dtype)
    spread = _spread_bits(torch.arange(1 << MORTON_BITS, dtype=torch.int64))
    table = torch.stack([spread, spread << 1, spread << 2], dim=1).to(torch.int32)
    return hi.to(device), table.to(device), torch.arange(3, device=device)


def entry_cells(x: torch.Tensor, v: torch.Tensor, shape: Tuple[int, int, int],
                h: float) -> torch.Tensor:
    """The ``(x, y, z)`` cell (int64, ``(N, 3)``) where each ray's line first meets the box.

    ``shape`` is the grid's ``(D, H, W)``.  The line ``x + t v`` for ``t >= 0``
    is cut with the three slabs; where it meets the box the point at the
    larger entry parameter (or the start, if the ray starts inside) is taken,
    otherwise the start itself; the point's cell is clamped into the grid.
    An axis the ray does not move along admits every ``t`` (start between
    the faces) or none; a start exactly on a lower face with no speed along
    that axis counts as none; a ray at rest takes its start.  The order is a
    heuristic: such edge cases only move a ray in it.
    """
    hi = _constants(x.device, x.dtype, tuple(shape), float(h))[0]
    inv = v.reciprocal()  # +-inf on an axis with no speed
    t0 = (x * inv).neg_()
    t1 = (hi - x).mul_(inv)
    t_in = torch.fmin(t0, t1).amax(dim=1).clamp_(min=0)  # fmin, fmax: 0 * inf is no side
    t_out = torch.fmax(t0, t1).amin(dim=1)
    # a line that misses the box, or a ray at rest outside it (t_in = t_out =
    # inf, and inf * 0 is no point): its start
    t_in.masked_fill_((t_in > t_out) | t_in.isinf(), 0)
    top = max(shape) - 2
    cell = torch.addcmul(x, t_in[:, None], v).div_(h).floor_().clamp_(0, max(top, 0))
    return cell.to(torch.int64)


def ray_key(x: torch.Tensor, v: torch.Tensor, shape: Tuple[int, int, int],
            h: float) -> torch.Tensor:
    """The int32 sort key of each ray: dominant axis and sign, then the Morton code."""
    _, table, axes = _constants(x.device, x.dtype, tuple(shape), float(h))
    cell = entry_cells(x, v, shape, h)
    res_max = max(shape)
    if res_max > (1 << MORTON_BITS) + 1:  # keep MORTON_BITS an axis, in order
        cell = cell * (1 << MORTON_BITS) // (res_max - 1)
    morton = table[cell, axes].sum(dim=1, dtype=torch.int32)  # disjoint bits: sum = or
    axis = v.abs().max(dim=1).indices
    # dominant axis and sign: 2 * axis + (component < 0), in the top bits
    octant = 2 * axis + (v.gather(1, axis[:, None])[:, 0] < 0)
    return morton.add_(octant.to(torch.int32) << (3 * MORTON_BITS))


def ray_order(x: torch.Tensor, v: torch.Tensor, shape: Tuple[int, int, int],
              h: float) -> torch.Tensor:
    """int32 permutation of the ``N`` rays ``(x, v)`` (each ``(N, 3)``) in key order."""
    return torch.argsort(ray_key(x, v, shape, h), stable=True).to(torch.int32)
