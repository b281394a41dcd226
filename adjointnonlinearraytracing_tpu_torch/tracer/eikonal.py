"""Eikonal ODE integrators in plain torch: forward stepper and adjoint sweep.

Twin of ``adjointnonlinearraytracing_tpu/tracer/eikonal.py`` (``trace``,
``trace_scan``, ``backtrace``, ``max_steps_fwd``, ``max_steps_bwd``).  Rays follow
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

The volume variants, twins of the JAX functions of the same names, take
K2's and K3's loops with another stop, capture or "inside" rule:
``trace_plane`` (a ray stops past its plane; ``miss`` marks rays that never
escaped), ``trace_target`` (closest approach to a target per ray, captured
at every step it gets closer, while the batch runs: an escaped ray keeps
stepping on a straight line until the last ray of the batch has escaped),
``trace_sdf`` ("inside" is ``sdf < 0`` on a second grid, read at the new
position under the previous step's inside) and ``backtrace_sdf`` (the
adjoint, which stops a ray where it crosses out of the sdf going back).
Their fixed-trip twins ``trace_plane_scan``, ``trace_target_scan`` and
``trace_sdf_scan`` are what the tape differentiates.  Kernels:
``kernels/csrc/trace_fwd.cu`` (K11-K13, rules of K2's loop) and
``kernels/csrc/backtrace.cu`` (K14, K3's ray with the sdf rule).

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


def dot3(a, b):
    """Row-wise dot product of ``(N, 3)`` rows, summed in the kernels' order."""
    return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]


def forward_step(field: G.GridField, x, v, inside, ds_t):
    """One step of the volume stepper: the eval masked by ``inside``,
    ``v += ds*n*grad n; x += ds*v``; returns the new ``x, v``."""
    n, nx = G.eval_grad_plain(field, x, inside)
    v = v + (ds_t * n)[:, None] * nx
    return x + ds_t * v, v


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
        x, v = forward_step(field, x, v, inside, ds_t)

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


def trace_scan(field: G.GridField, x0, v0, ds: float, max_steps: int):
    """Fixed-trip twin of :func:`trace` (always ``max_steps`` steps, as the JAX
    ``lax.scan`` version), differentiable with plain autograd: the tape the
    reference's ``ADTracerC`` keeps, used to cross-validate the adjoint.
    The same ``(xt, vt)`` as :func:`trace`: an escaped ray is outside and
    moving away, so its later steps change nothing it reports."""
    x, v, xt, vt = x0, v0, x0, v0
    inside = G.inbounds(field, x0)
    esc = torch.zeros_like(inside)
    ds_t = G._scalar(ds, x0)
    for _ in range(max_steps):
        x, v = forward_step(field, x, v, inside, ds_t)
        cur_inside = G.inbounds(field, x)
        cross = inside & ~cur_inside
        esc = esc | cross | G.escaped(field, x, v)
        xt = _where3(cross, x, xt)
        vt = _where3(cross, v, vt)
        inside = cur_inside
    return _where3(esc, xt, x), vt


def _plane_inside(field, x, pln_o, pln_d):
    """In the grid and not past the plane ``(x - o) . d > 0``."""
    return G.inbounds(field, x) & ~(dot3(x - pln_o, pln_d) > 0)


def trace_plane(field: G.GridField, x0, v0, pln_o, pln_d, ds: float, max_steps: int,
                stats: Optional[dict] = None):
    """Trace with the extra stop past each ray's plane (``pln_o``, ``pln_d``:
    (N, 3)); returns ``(xt, vt, miss)``, ``miss`` marking the rays that never
    escaped.  As :func:`trace` otherwise ("inside" is in the grid and not
    past the plane); ``stats`` as there.  A ray that escaped never crosses
    again (it is outside the grid moving away, or past its plane moving on),
    so leaving the loop per ray is exact."""
    x, v, xt, vt = x0, v0, x0, v0
    inside = G.inbounds(field, x0)
    esc = torch.zeros_like(inside)
    ds_t = G._scalar(ds, x0)
    ray_steps = evals = 0

    step = 0
    while step < max_steps and not bool(esc.all()):
        if stats is not None:
            ray_steps += int((~esc).sum())
            evals += int((inside & ~esc).sum())
        x, v = forward_step(field, x, v, inside, ds_t)
        cur_inside = _plane_inside(field, x, pln_o, pln_d)
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
    return xt, vt, ~esc


def trace_plane_scan(field: G.GridField, x0, v0, pln_o, pln_d, ds: float, max_steps: int):
    """Fixed-trip twin of :func:`trace_plane` (always ``max_steps`` steps),
    differentiable with plain autograd."""
    x, v, xt, vt = x0, v0, x0, v0
    inside = G.inbounds(field, x0)
    esc = torch.zeros_like(inside)
    ds_t = G._scalar(ds, x0)
    for _ in range(max_steps):
        x, v = forward_step(field, x, v, inside, ds_t)
        cur_inside = _plane_inside(field, x, pln_o, pln_d)
        cross = inside & ~cur_inside
        esc = esc | cross | G.escaped(field, x, v)
        xt = _where3(cross, x, xt)
        vt = _where3(cross, v, vt)
        inside = cur_inside
    return _where3(esc, xt, x), vt, ~esc


def _target_step(field, x, v, xt, vt, d2, inside, esc, target, ds_t):
    """One step of the target stepper with its capture; returns the new state."""
    x, v = forward_step(field, x, v, inside, ds_t)
    cur_d2 = sum_sq3(x - target)
    closer = cur_d2 < d2
    cur_inside = G.inbounds(field, x)
    esc = esc | (inside & ~cur_inside) | G.escaped(field, x, v)
    xt = _where3(closer, x, xt)
    vt = _where3(closer, v, vt)
    d2 = torch.where(closer, cur_d2, d2)
    return x, v, xt, vt, d2, cur_inside, esc


def trace_target(field: G.GridField, x0, v0, target, ds: float, max_steps: int,
                 stats: Optional[dict] = None):
    """Trace recording each ray's closest approach to its ``target`` (N, 3);
    returns ``(xt, vt, d2)`` at the step the squared distance last dropped
    (``cur < d2``).  No fix-up of rays that never escaped.

    The loop runs while any ray of the batch has not escaped (or to
    ``max_steps``), and an escaped ray keeps stepping: outside the grid its
    eval is masked, so it goes straight, and it is still captured whenever it
    gets closer.  So a ray's result depends on when the last ray of its batch
    escaped.  ``stats`` gets ``ray_steps`` (steps of rays not yet escaped),
    ``evals`` (those inside the grid), ``horizon`` (the steps the loop ran)
    and ``ballistic_steps`` (steps of rays already escaped)."""
    x, v, xt, vt = x0, v0, x0, v0
    inside = G.inbounds(field, x0)
    esc = torch.zeros_like(inside)
    ds_t = G._scalar(ds, x0)
    d2 = sum_sq3(x0 - target)
    ray_steps = evals = 0

    step = 0
    while step < max_steps and not bool(esc.all()):
        if stats is not None:
            ray_steps += int((~esc).sum())
            evals += int((inside & ~esc).sum())
        x, v, xt, vt, d2, inside, esc = _target_step(field, x, v, xt, vt, d2, inside, esc,
                                                     target, ds_t)
        step += 1
    if stats is not None:
        stats.update(ray_steps=ray_steps, evals=evals, horizon=step,
                     ballistic_steps=step * x0.shape[0] - ray_steps)
    return xt, vt, d2


def trace_target_scan(field: G.GridField, x0, v0, target, ds: float, max_steps: int):
    """Taped twin of :func:`trace_target`, differentiable with plain autograd:
    its steps are gated on ``~all(esc)`` (the JAX ``lax.scan`` version masks
    every step after that; here the loop ends there), so it captures exactly
    where :func:`trace_target` does."""
    x, v, xt, vt = x0, v0, x0, v0
    inside = G.inbounds(field, x0)
    esc = torch.zeros_like(inside)
    ds_t = G._scalar(ds, x0)
    d2 = sum_sq3(x0 - target)
    for _ in range(max_steps):
        if bool(esc.all()):
            break
        x, v, xt, vt, d2, inside, esc = _target_step(field, x, v, xt, vt, d2, inside, esc,
                                                     target, ds_t)
    return xt, vt, d2


def _sdf_step(field, sdf, x, v, xt, vt, inside, esc, ds_t):
    """One step of the sdf stepper: "inside" at the new ``x`` is ``sdf < 0``,
    the sdf read under the previous ``inside`` (so a ray outside reads 0 and
    stays outside); captured at the inside -> outside crossing."""
    x, v = forward_step(field, x, v, inside, ds_t)
    dist, _ = G.eval_grad_plain(sdf, x, inside)
    cur_inside = dist < 0
    cross = inside & ~cur_inside
    esc = esc | cross | G.escaped(field, x, v)
    return x, v, _where3(cross, x, xt), _where3(cross, v, vt), cur_inside, esc


def trace_sdf(field: G.GridField, sdf: G.GridField, x0, v0, ds: float, max_steps: int,
              stats: Optional[dict] = None):
    """Trace where the medium is ``sdf < 0`` (``sdf`` on ``field``'s lattice);
    returns ``(xt, vt)`` at the crossing out of it, ``(x0, v0)`` for a ray
    that never crossed (no fix-up).  The first step's "inside" is
    ``inbounds(x0)`` on the grid; escape is tested on the grid.  The loop runs
    while any ray has not escaped: a ray that escaped the grid while still
    inside the sdf (clamped corners can read ``sdf < 0`` outside the grid)
    keeps stepping, and may still cross, until the last ray escapes.
    ``stats`` gets ``ray_steps`` (steps of rays not yet escaped), ``evals``
    (those that evaluated both grids), ``horizon`` (the steps the loop ran)
    and ``late_steps`` (steps of escaped rays still inside the sdf)."""
    x, v, xt, vt = x0, v0, x0, v0
    inside = G.inbounds(field, x0)
    esc = torch.zeros_like(inside)
    ds_t = G._scalar(ds, x0)
    ray_steps = evals = late = 0

    step = 0
    while step < max_steps and not bool(esc.all()):
        if stats is not None:
            ray_steps += int((~esc).sum())
            evals += int((inside & ~esc).sum())
            late += int((inside & esc).sum())
        x, v, xt, vt, inside, esc = _sdf_step(field, sdf, x, v, xt, vt, inside, esc, ds_t)
        step += 1
    if stats is not None:
        stats.update(ray_steps=ray_steps, evals=evals, horizon=step, late_steps=late)
    return xt, vt


def trace_sdf_scan(field: G.GridField, sdf: G.GridField, x0, v0, ds: float, max_steps: int):
    """Fixed-trip twin of :func:`trace_sdf` (always ``max_steps`` steps, as
    the JAX ``lax.scan`` version), differentiable with plain autograd."""
    x, v, xt, vt = x0, v0, x0, v0
    inside = G.inbounds(field, x0)
    esc = torch.zeros_like(inside)
    ds_t = G._scalar(ds, x0)
    for _ in range(max_steps):
        x, v, xt, vt, inside, esc = _sdf_step(field, sdf, x, v, xt, vt, inside, esc, ds_t)
    return xt, vt


def backtrace(field: G.GridField, xt, vt, dx, dv, ds: float, max_steps: int,
              stats: Optional[dict] = None, acc_dtype: Optional[torch.dtype] = None,
              sdf: Optional[G.GridField] = None):
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

    With ``sdf`` (a grid on ``field``'s lattice) it is :func:`backtrace_sdf`.
    """
    ds_t = G._scalar(ds, xt)
    x, v = xt, vt
    la = dx
    mu = dv + ds_t * dx
    active = ~G.escaped(field, xt, -vt)
    if sdf is not None:
        outside = G.eval_grad_plain(sdf, xt, active)[0] >= 0
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

        if sdf is not None:
            dist = G.eval_grad_plain(sdf, xe, active)[0]
        active = active & ~G.escaped(field, xe, -v)
        if sdf is not None:
            active = active & ~(~outside & (dist >= 0))
            outside = dist >= 0

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


def backtrace_sdf(field: G.GridField, sdf: G.GridField, xt, vt, dx, dv, ds: float,
                  max_steps: int, stats: Optional[dict] = None,
                  acc_dtype: Optional[torch.dtype] = None):
    """Adjoint sweep with sdf-crossing deactivation; returns the flat voxel
    gradient of ``field`` (the sdf gets none).

    :func:`backtrace` with a second state ``outside``: at the start
    ``sdf(xt) >= 0`` (unsnapped, read where the ray is active); each step reads
    ``dist = sdf`` at the snapped ``xe`` under the **old** ``active``, then
    ``active &= !escaped(xe, -v)``, a ray that was inside and reads
    ``dist >= 0`` (it crossed out going back) turns inactive, and
    ``outside = dist >= 0``; the splat is masked by the **new** ``active``.
    ``stats`` and ``acc_dtype`` as there."""
    return backtrace(field, xt, vt, dx, dv, ds, max_steps, stats=stats, acc_dtype=acc_dtype,
                     sdf=sdf)


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
