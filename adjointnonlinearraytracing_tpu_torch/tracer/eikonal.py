"""Eikonal ODE integrators in plain torch: forward stepper and adjoint sweep.

Twin of ``adjointnonlinearraytracing_tpu/tracer/eikonal.py`` (``trace``,
``backtrace``, ``max_steps_fwd``, ``max_steps_bwd``).  Rays follow
``dx/ds = v, dv/ds = n * grad(n)``, integrated with fixed-step symplectic
Euler — ``v += ds * n * grad_n;  x += ds * v`` — with per-ray masks and
exit-state capture at the inside->outside crossing.  The backward pass is the
constant-memory adjoint: from the exit state and the loss cotangents
``(dx, dv)`` it re-integrates the ray in reverse while evolving
``la = dx``, ``mu = dv + ds*dx`` and scatter-adding per-step contributions
into the voxel-gradient grid.

These are the **plain versions** of the CUDA kernels
``kernels/csrc/trace_fwd.cu`` and ``kernels/csrc/backtrace.cu``: a Python
``while`` over batched tensors, with ``index_add_`` for the splat.  They are
the oracle the kernels are held against and what CPU tensors run through;
``tracer/api.py`` sends CUDA tensors to the kernels instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..fields import grid as G


def max_steps_fwd(res_max: int, h: float, ds: float) -> int:
    """Forward step bound: ``int(4 * h * max(res) / ds)``."""
    return int(4.0 * h * res_max / ds)


def max_steps_bwd(res_max: int, h: float, ds: float) -> int:
    """Backward step bound: ``int(2 * h * max(res) / ds)``."""
    return int(2.0 * h * res_max / ds)


def _where3(m, a, b):
    return torch.where(m[:, None], a, b)


def trace(field: G.GridField, x0, v0, ds: float, max_steps: int,
          stats: Optional[dict] = None):
    """Basic volume trace; returns the exit state ``(xt, vt)``.

    ``xt, vt`` are captured at the inside->outside crossing only; a ray that
    never escaped reports its final position in ``xt`` while ``vt`` keeps the
    start direction.  When ``stats`` is a dict, ``stats["ray_steps"]`` gets the
    number of steps taken by rays that had not yet escaped (the work a per-ray
    early exit needs) and ``stats["evals"]`` how many of those evaluated the
    field (the ray was inside the grid).
    """
    x, v, xt, vt = x0, v0, x0, v0
    inside = G.inbounds(field, x0)
    esc = torch.zeros_like(inside)
    ds_t = G._scalar(ds, x0)
    ray_steps = 0
    evals = 0

    step = 0
    while step < max_steps and not bool(esc.all()):
        if stats is not None:
            ray_steps += int((~esc).sum())
            evals += int((inside & ~esc).sum())
        n, nx = G.eval_grad_plain(field, x, inside)
        v = v + (ds_t * n)[:, None] * nx
        x = x + ds_t * v

        cur_inside = G.inbounds(field, x)
        cross = inside & ~cur_inside
        esc = esc | cross | G.escaped(field, x, v)

        xt = _where3(cross, x, xt)
        vt = _where3(cross, v, vt)
        inside = cur_inside
        step += 1

    xt = _where3(esc, xt, x)
    if stats is not None:
        stats["ray_steps"] = ray_steps
        stats["evals"] = evals
    return xt, vt


def backtrace(field: G.GridField, xt, vt, dx, dv, ds: float, max_steps: int,
              stats: Optional[dict] = None, acc_dtype: Optional[torch.dtype] = None):
    """Adjoint reverse sweep; returns the flat voxel gradient.

    Eval and splat are masked by ``active & inbounds(snapped x)``, which makes
    the reverse sweep an exact inverse of the forward even for rays that graze
    outside the grid mid-trajectory; the integration position stays unsnapped,
    only the evaluation point is snapped.  When ``stats`` is a dict it gets
    ``ray_steps`` (steps taken by active rays), ``evals`` (those that
    evaluated the field), ``splats`` (those that scatter, 8 terms each) and
    ``flushes``: the runs of splats, a run being a ray's consecutive splats
    into the same clamped stencil (the same 8 indices), i.e. the splats
    whose stencil differs from that ray's previous splat's, the first splat
    of a ray included.  K3 sums a run in registers and flushes it with 8
    atomic adds, so it flushes exactly ``flushes`` runs; lanes of a warp
    that flush into the same stencil at once sum first, so it issues at
    most ``8 * flushes`` adds into its accumulator (device memory, or a
    block's shared memory where the gradient fits there).

    ``acc_dtype`` (default: the field's) is the type the gradient is summed
    and returned in: float64 sums the same float32 terms with a rounding
    error far below theirs, a reference for how well a float32 sum of
    millions of terms came out.
    """
    ds_t = G._scalar(ds, xt)
    x, v = xt, vt
    la = dx
    mu = dv + ds_t * dx
    active = ~G.escaped(field, xt, -vt)
    g = torch.zeros((field.data.numel(),), dtype=acc_dtype or field.data.dtype,
                    device=field.data.device)
    ray_steps = 0
    evals = 0
    splats = 0
    flushes = 0
    numel = field.data.numel()
    last = torch.full((xt.shape[0],), -1, dtype=torch.int64, device=xt.device)

    step = 0
    while step < max_steps and bool(active.any()):
        if stats is not None:
            ray_steps += int(active.sum())
        x = x - ds_t * v
        xe = G.snap_to_nodes(x, field.h)
        emask = active & G.inbounds(field, xe)
        n, nx = G.eval_grad_plain(field, xe, emask)
        hess = G.eval_hess(field, xe, emask)
        v = v - (ds_t * n)[:, None] * nx

        active = active & ~G.escaped(field, xe, -v)

        dn = mu[:, 0] * nx[:, 0] + mu[:, 1] * nx[:, 1] + mu[:, 2] * nx[:, 2]
        dnx = n[:, None] * mu
        smask = active & emask
        if stats is not None:
            evals += int(emask.sum())
            splats += int(smask.sum())
            idx = G._stencil(field, xe)[0]
            key = idx[0, 0, 0] * numel + idx[1, 1, 1]
            flushes += int((smask & (key != last)).sum())
            last = torch.where(smask, key, last)
        G.scatter_into(g, field, xe, dn * ds_t, dnx * ds_t, smask)

        la = la + ds_t * (dn[:, None] * nx + n[:, None] * G.hess_matvec(hess, mu))
        mu = mu + ds_t * la
        step += 1

    if stats is not None:
        stats["ray_steps"] = ray_steps
        stats["evals"] = evals
        stats["splats"] = splats
        stats["flushes"] = flushes
    return g
