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

The cylinder variant (``trace_cable``, ``backtrace_cable``, and
``trace_cable_scan``, the fixed-trip loop the tape differentiates) traces a
radial profile (``fields/cylinder.py``) toward a target point per ray and
reports the closest approach; its kernels are ``kernels/csrc/trace_cable.cu``
and ``kernels/csrc/backtrace_cable.cu``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..fields import cylinder as C
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


# ---------------------------------------------------------------------------
# The cylinder (cable) variant
# ---------------------------------------------------------------------------

def sum_sq3(d):
    """Squared norm of the rows of ``d`` (N, 3), summed in the kernels' order."""
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def cable_step(field: C.CylinderField, x, v, active, ds_t):
    """One step of the cable stepper: the eval is unmasked, only active lanes
    move (``v += ds*n*grad n; x += ds*v``); returns the new ``x, v``."""
    n, nx = C.cyl_eval_grad(field, x)
    vn = v + (ds_t * n)[:, None] * nx
    v = _where3(active, vn, v)
    return _where3(active, x + ds_t * v, x), v


def cable_advance(field: C.CylinderField, x, v, inside, esc, target, ds_t):
    """One step of the cable stepper with its bookkeeping: only the lanes not
    yet escaped move; returns the new ``x``, ``v``, squared distance to
    ``target``, ``inside`` and ``esc`` (crossed out of the cylinder, or
    outside and receding)."""
    x, v = cable_step(field, x, v, ~esc, ds_t)
    cur_inside = C.cyl_inbounds(field, x)
    esc = esc | (inside & ~cur_inside) | C.cyl_escaped(field, x, v)
    return x, v, sum_sq3(x - target), cur_inside, esc


def trace_cable(field: C.CylinderField, x0, v0, target, ds: float, max_steps: int,
                stats: Optional[dict] = None):
    """Cylinder-volume trace toward ``target`` (N, 3); returns the closest
    approach ``(xt, vt, dist2)``.

    Only active (not yet escaped) lanes advance, and the closest approach is
    captured at every step where the squared distance drops (``cur < d2``),
    not at the crossing.  A lane freezes once it crosses out of the cylinder
    or is outside and receding (``cyl_escaped``); a frozen lane's distance no
    longer changes, so leaving the loop per lane is exact.  ``stats`` gets
    ``ray_steps``: the steps taken by lanes still active.
    """
    inside = C.cyl_inbounds(field, x0)
    esc = torch.zeros_like(inside)
    ds_t = G._scalar(ds, x0)
    d2 = sum_sq3(x0 - target)
    x, v, xt, vt = x0, v0, x0, v0
    ray_steps = 0

    step = 0
    while step < max_steps and not bool(esc.all()):
        if stats is not None:
            ray_steps += int((~esc).sum())
        x, v, cur_d2, inside, esc = cable_advance(field, x, v, inside, esc, target, ds_t)
        closer = cur_d2 < d2
        xt = _where3(closer, x, xt)
        vt = _where3(closer, v, vt)
        d2 = torch.where(closer, cur_d2, d2)
        step += 1
    if stats is not None:
        stats["ray_steps"] = ray_steps
    return xt, vt, d2


def trace_cable_scan(field: C.CylinderField, x0, v0, target, ds: float, max_steps: int):
    """Fixed-trip twin of :func:`trace_cable` (the JAX ``lax.scan`` version):
    always ``max_steps`` steps, differentiable with plain autograd.  Frozen
    lanes do not move, so it returns :func:`trace_cable`'s result."""
    inside = C.cyl_inbounds(field, x0)
    esc = torch.zeros_like(inside)
    ds_t = G._scalar(ds, x0)
    d2 = sum_sq3(x0 - target)
    x, v, xt, vt = x0, v0, x0, v0
    for _ in range(max_steps):
        x, v, cur_d2, inside, esc = cable_advance(field, x, v, inside, esc, target, ds_t)
        closer = cur_d2 < d2
        xt = _where3(closer, x, xt)
        vt = _where3(closer, v, vt)
        d2 = torch.where(closer, cur_d2, d2)
    return xt, vt, d2


def backtrace_cable(field: C.CylinderField, xt, vt, dx, dv, ds: float, max_steps: int,
                    stats: Optional[dict] = None, acc_dtype: Optional[torch.dtype] = None):
    """Adjoint sweep through the cylinder; returns the radial-profile gradient.

    Per step: unmasked ``x -= ds*v``; the evaluation point ``xe`` is ``x``
    with its y snapped onto a cap plane (``y = 0`` or ``y = length``) where
    it lies within ``snap_tol * radius`` of one (1e-9 radii in f64, 1e-3 in
    f32); eval and Hessian at ``xe``
    masked by the **old** ``active``; ``v -= ds*n*grad n``; ``active &=
    !cyl_escaped(xe, -v)``; the splat ``(dn*ds, n*mu*ds)`` masked by the
    **new** ``active``; then ``la += ds*(dn*grad n + n*H mu)``,
    ``mu += ds*la``.  Start: ``la = dx``, ``mu = dv + ds*dx``,
    ``active = !cyl_escaped(xt, -vt)``.  ``stats`` gets ``ray_steps`` (steps
    of active lanes) and ``splats``; ``acc_dtype`` as for :func:`backtrace`.
    """
    ds_t = G._scalar(ds, xt)
    x, v = xt, vt
    la = dx
    mu = dv + ds_t * dx
    active = ~C.cyl_escaped(field, xt, -vt)
    g = torch.zeros(field.data.shape, dtype=acc_dtype or field.data.dtype,
                    device=field.data.device)
    cap = G._scalar(G.snap_tol(xt.dtype) * field.radius, xt)
    length = G._scalar(field.length, xt)
    ray_steps = splats = 0

    step = 0
    while step < max_steps and bool(active.any()):
        if stats is not None:
            ray_steps += int(active.sum())
        x = x - ds_t * v
        y = torch.where(x[:, 1].abs() <= cap, torch.zeros_like(x[:, 1]), x[:, 1])
        y = torch.where((y - length).abs() <= cap, length, y)
        xe = torch.stack([x[:, 0], y, x[:, 2]], dim=-1)
        n, nx = C.cyl_eval_grad(field, xe, active)
        hess = C.cyl_eval_hess(field, xe, active)
        v = v - (ds_t * n)[:, None] * nx

        active = active & ~C.cyl_escaped(field, xe, -v)

        dn = (mu[:, 0] * nx[:, 0] + mu[:, 1] * nx[:, 1]) + mu[:, 2] * nx[:, 2]
        dnx = n[:, None] * mu
        if stats is not None:
            splats += int(active.sum())
        C.cyl_scatter_into(g, field, xe, dn * ds_t, dnx * ds_t, active)

        la = la + ds_t * (dn[:, None] * nx + n[:, None] * C.cyl_hess_matvec(hess, mu))
        mu = mu + ds_t * la
        step += 1

    if stats is not None:
        stats["ray_steps"] = ray_steps
        stats["splats"] = splats
    return g
