"""Checkpointed-segment adjoint: the exact gradient of the volume trace.

Twin of ``adjointnonlinearraytracing_tpu/tracer/checkpointed.py``, plain and
cable variants (``trace_exact``, ``trace_cable_exact``; the plane, target and
sdf variants wait for their trace variants, ``ROADMAP.md`` A5).

The constant-memory adjoint (``tracer.api.trace``) re-integrates each ray in
reverse; in float32 the reconstructed path drifts on rough fields and the
gradient with it.  Here the forward stepper stores a checkpoint
``(x, v, inside)`` every ``seg`` steps plus each ray's capture step ``c`` (the
step whose state became the output), and the backward pass replays each
segment forward from its checkpoint, so every adjoint update sees the exact
forward positions, while it runs the ``la``/``mu`` recursion in reverse across
segments, gated on ``k < c``.  That is the exact discrete gradient (autograd
through the unrolled forward, at any precision) with ``O(N * (steps/seg +
seg))`` memory instead of the tape's ``O(N * steps)``.

Semantics carried over from the JAX package:

* ``c`` starts at ``max_steps`` and becomes ``k + 1`` at the inside->outside
  crossing of step ``k``; the last segment may be partial; a segment is
  skipped once every ray has escaped; a ray that never escaped reports its
  final position (``xt = where(esc, xt, x)``) and its start direction, so its
  ``vt`` cotangent is zeroed in the backward pass.
* In the backward pass the eval mask is ``k < c & inside_k`` (no
  ``snap_to_nodes``: the replayed positions are the forward's own); start
  ``la = dx``, ``mu = dv + ds*dx``.
* Only ``rif`` gets a gradient; ``x`` and ``v`` get zeros.
* Batches above ``ANRT_EXACT_CHUNK`` rays (default 2^18) run the backward pass
  chunk by chunk along the ray axis, recomputing each chunk's checkpoints:
  memory stays bounded and the result does not depend on the chunking.

Where it runs: CUDA tensors go through the kernels K5 ``trace_ckpt`` (K2's
stepper, also writing the checkpoints, ``kernels/csrc/trace_fwd.cu``) and K6
``backtrace_exact`` (``kernels/csrc/backtrace_exact.cu``), with the ray order
of ``tracer/order.py``; CPU tensors through the plain functions below, which
are the kernels' plain versions.  There is no fallback from one to the other.

The cable variant (``trace_cable_exact``, the radial profile of
``fields/cylinder.py``) freezes a lane once it escapes and evaluates the field
unmasked, so its checkpoints hold ``(x, v, esc)``; its capture step ``c`` is
the last step whose closest approach became the output (0 if none), and a
lane is active at every step below it, so the backward pass is gated by
``k < c`` alone.  Its kernels are K9 ``trace_cable_ckpt`` (K7's loop writing
the checkpoints, ``kernels/csrc/trace_cable.cu``) and K10
``backtrace_cable_exact`` (``kernels/csrc/backtrace_cable_exact.cu``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..fields import cylinder as C
from ..fields import grid as G
from ..kernels import wrappers as K
from . import eikonal as E
from . import order as O
from .api import _check_cable, _check_rays, _check_rif, bcast_per_ray3, cable_steps


def _where3(m, a, b):
    return torch.where(m[:, None], a, b)


def _step(field: G.GridField, x, v, inside, ds_t):
    """One forward step (the stepper's) and ``inbounds`` at the new position."""
    x2, v2 = E.forward_step(field, x, v, inside, ds_t)
    return x2, v2, G.inbounds(field, x2)


def _forward_with_ckpts(field: G.GridField, x0, v0, ds: float, max_steps: int, seg: int,
                        store_ckpts: bool = True, stats: Optional[dict] = None):
    """Segmented forward; returns ``(xt, vt, esc, c, captured, ckpts)``.

    ``ckpts`` is the ``(nseg, 7, N)`` stack of ``(x, v, inside)`` at each
    segment start, one field of all the rays to a row, as K5 writes it
    (``None`` when ``store_ckpts`` is false); ``c`` (int32) the
    capture step; ``captured`` whether the ray crossed out of the grid.  A ray
    that escaped without being captured was never inside (a ray that was
    inside leaves only by crossing), so its gradient is zero.  ``stats`` as
    for ``eikonal.trace``: ``ray_steps`` of rays not yet escaped and ``evals``
    of those inside.
    """
    nseg = -(-max_steps // seg)
    n = x0.shape[0]
    ds_t = G._scalar(ds, x0)
    x, v, xt, vt = x0, v0, x0, v0
    inside = G.inbounds(field, x0)
    esc = torch.zeros_like(inside)
    captured = torch.zeros_like(inside)
    c = torch.full((n,), max_steps, dtype=torch.int32, device=x0.device)
    ckpts = []
    ray_steps = evals = 0
    for s in range(nseg):
        if store_ckpts:
            ckpts.append(torch.cat([x.T, v.T, inside.to(x.dtype)[None]]))
        if bool(esc.all()):
            continue
        for j in range(min(seg, max_steps - s * seg)):
            if stats is not None:
                ray_steps += int((~esc).sum())
                evals += int((inside & ~esc).sum())
            x, v, cur = _step(field, x, v, inside, ds_t)
            cap = inside & ~cur
            esc = esc | cap | G.escaped(field, x, v)
            xt = _where3(cap, x, xt)
            vt = _where3(cap, v, vt)
            c = torch.where(cap, s * seg + j + 1, c)
            captured = captured | cap
            inside = cur
    xt = _where3(esc, xt, x)  # failed-to-exit fix-up: report the final position
    if stats is not None:
        stats["ray_steps"] = ray_steps
        stats["evals"] = evals
    return xt, vt, esc, c, captured, (torch.stack(ckpts) if store_ckpts else None)


def _backward_segments(field: G.GridField, ckpts, c, dx, dv, ds: float, seg: int,
                       acc_dtype: Optional[torch.dtype] = None,
                       stats: Optional[dict] = None, out: Optional[torch.Tensor] = None):
    """Replay the segments in reverse; the exact ``la``/``mu`` recursion gated on ``k < c``.

    Returns the flat voxel gradient, summed in ``acc_dtype`` (default: the
    field's; float64 sums the same float32 terms as a reference), added into
    ``out`` when given.  ``stats`` gets ``ray_steps`` (gated-on steps of the
    rays whose gradient is not zero: each is a replayed step and a backward
    step), ``evals`` (those inside: each evaluates and splats) and
    ``flushes``, the runs of splats as ``eikonal.backtrace`` counts them.
    """
    nseg = ckpts.shape[0]
    ds_t = G._scalar(ds, dx)
    la = dx
    mu = dv + ds_t * dx
    g = out if out is not None else torch.zeros(
        (field.data.numel(),), dtype=acc_dtype or field.data.dtype, device=field.data.device)
    max_c = int(c.max()) if c.numel() else 0
    numel = field.data.numel()
    last = torch.full((c.shape[0],), -1, dtype=torch.int64, device=c.device)
    ray_steps = evals = flushes = 0
    if stats is not None:
        # a ray that escaped without ever being inside has no evaluation
        live = stats.pop("live")
    for s in range(nseg - 1, -1, -1):
        if s * seg >= max_c:
            continue  # past every ray's capture step
        x, v, inside = ckpts[s, :3].T.contiguous(), ckpts[s, 3:6].T.contiguous(), ckpts[s, 6] > 0.5
        xs, ins = [], []
        for _ in range(seg):  # the forward positions and masks of the segment
            xs.append(x)
            ins.append(inside)
            x, v, inside = _step(field, x, v, inside, ds_t)
        for j in range(seg - 1, -1, -1):
            xk = xs[j]
            gate = (s * seg + j) < c
            emask = gate & ins[j]
            n, nx = G.eval_grad_plain(field, xk, emask)
            hess = G.eval_hess(field, xk, emask)
            dn = mu[:, 0] * nx[:, 0] + mu[:, 1] * nx[:, 1] + mu[:, 2] * nx[:, 2]
            dnx = n[:, None] * mu
            if stats is not None:
                ray_steps += int((gate & live).sum())
                evals += int(emask.sum())
                idx = G._stencil(field, xk)[0]
                key = idx[0, 0, 0] * numel + idx[1, 1, 1]
                flushes += int((emask & (key != last)).sum())
                last = torch.where(emask, key, last)
            G.scatter_into(g, field, xk, dn * ds_t, dnx * ds_t, emask)
            la2 = la + ds_t * (dn[:, None] * nx + n[:, None] * G.hess_matvec(hess, mu))
            mu2 = mu + ds_t * la2
            la = _where3(gate, la2, la)
            mu = _where3(gate, mu2, mu)
    if stats is not None:
        stats["ray_steps"] = ray_steps
        stats["evals"] = evals
        stats["splats"] = evals
        stats["flushes"] = flushes
    return g


def exact_chunk_rays() -> int:
    """Ray-axis microbatch of the exact path's backward pass (0: no chunking).

    ``ANRT_EXACT_CHUNK``, default 2^18 = 262,144 rays.  The checkpoints of a
    chunk take ``nseg * chunk * 7`` elements: 176 MB in f32 at the fuel
    trainer's 3^3 stage (768 steps, seg 32) and 235 MB at the bench scene
    (1024 steps)."""
    return int(os.environ.get("ANRT_EXACT_CHUNK", str(1 << 18)))


def _chunks(n: int, chunk: int):
    if not chunk or n <= chunk:
        return [slice(0, n)]
    return [slice(a, min(a + chunk, n)) for a in range(0, n, chunk)]


def backtrace_plain(rif, x, v, esc, c, ckpts, dxt, dvt, h: float, ds: float, seg: int = 32,
                    acc_dtype: Optional[torch.dtype] = None, stats: Optional[dict] = None):
    """The exact path's backward pass in plain torch: the flat voxel gradient.

    ``x, v`` are the rays' start; ``esc, c, ckpts`` what
    :func:`_forward_with_ckpts` returned (``ckpts`` ``None`` above the chunk
    size).  Without checkpoints, each chunk of ``ANRT_EXACT_CHUNK`` rays
    recomputes its own.  ``stats`` sums :func:`_backward_segments`'s over the
    chunks and needs the forward's ``captured`` under the key ``"captured"``.
    """
    field = G.GridField(rif, h)
    steps = E.max_steps_fwd(max(rif.shape), h, ds)
    dvt = torch.where(esc[:, None], dvt, torch.zeros_like(dvt))  # vt of a never-exited ray is v0
    g = torch.zeros((rif.numel(),), dtype=acc_dtype or rif.dtype, device=rif.device)
    captured = None if stats is None else stats.pop("captured")
    totals = {}
    for sl in _chunks(x.shape[0], 0 if ckpts is not None else exact_chunk_rays()):
        if ckpts is None:
            _, _, esc_c, c_c, cap_c, ck = _forward_with_ckpts(field, x[sl], v[sl], ds, steps, seg)
        else:
            esc_c, c_c, cap_c, ck = esc, c, captured, ckpts
        st = None
        if stats is not None:
            st = {"live": cap_c | ~esc_c}
        _backward_segments(field, ck, c_c, dxt[sl], dvt[sl], ds, seg, stats=st, out=g)
        for k, val in (st or {}).items():
            totals[k] = totals.get(k, 0) + val
    if stats is not None:
        stats.update(totals)
    return g


class _TraceExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rif, x, v, h, ds, seg, grad_needed):
        rif, x, v = (t.detach().contiguous() for t in (rif, x, v))
        steps = E.max_steps_fwd(max(rif.shape), h, ds)
        # checkpoints are kept only for a backward pass that will read them
        store = grad_needed and len(_chunks(x.shape[0], exact_chunk_rays())) == 1
        if rif.is_cuda:
            order = O.ray_order(x, v, rif.shape, h)
            xt, vt, c, code, ckpts = K.trace_ckpt(rif, h, x, v, ds, steps, seg, order,
                                                  store_ckpts=store)
            esc = code != 0
        else:
            order = code = None
            xt, vt, esc, c, _, ckpts = _forward_with_ckpts(G.GridField(rif, h), x, v, ds,
                                                           steps, seg, store)
        ctx.save_for_backward(rif, x, v, esc, c, code, ckpts, order)
        ctx.h, ctx.ds, ctx.seg = h, ds, seg
        return xt, vt

    @staticmethod
    def backward(ctx, dxt, dvt):
        rif, x, v, esc, c, code, ckpts, order = ctx.saved_tensors
        h, ds, seg = ctx.h, ctx.ds, ctx.seg
        dxt, dvt = dxt.contiguous(), dvt.contiguous()
        if rif.is_cuda:
            dvt = torch.where(esc[:, None], dvt, torch.zeros_like(dvt))
            g = torch.zeros((rif.numel(),), dtype=rif.dtype, device=rif.device)
            steps = E.max_steps_fwd(max(rif.shape), h, ds)
            for sl in _chunks(x.shape[0], 0 if ckpts is not None else exact_chunk_rays()):
                ck = ckpts
                if ck is None:  # recompute this chunk's checkpoints
                    ck = K.trace_ckpt(rif, h, x, v, ds, steps, seg, order[sl],
                                      exit_state=False)[4]
                K.backtrace_exact(rif, h, ck, c, code, dxt, dvt, ds, seg, order[sl], out=g)
        else:
            g = backtrace_plain(rif, x, v, esc, c, ckpts, dxt, dvt, h, ds, seg)
        gx = torch.zeros_like(x) if ctx.needs_input_grad[1] else None
        gv = torch.zeros_like(v) if ctx.needs_input_grad[2] else None
        return g.reshape(rif.shape), gx, gv, None, None, None, None


def trace_exact(rif: torch.Tensor, x: torch.Tensor, v: torch.Tensor, h: float, ds: float,
                seg: int = 32):
    """Volume trace whose gradient is the exact discrete adjoint.

    Same forward semantics as :func:`tracer.api.trace` (the exit state
    ``(xt, vt)``, equal to it bit for bit); the backward pass replays segments
    from checkpoints instead of re-integrating in reverse, so the gradient
    equals autograd through the plain stepper (:func:`tracer.api.trace_ad`)
    to rounding at any precision.  ``rif`` gets the gradient, ``x`` and ``v``
    zeros.  Memory: ``O(min(N, ANRT_EXACT_CHUNK) * (steps/seg + seg))``.
    """
    _check_rif(rif, "trace_exact")
    _check_rays(x, v, "trace_exact")
    if int(seg) < 1:
        raise ValueError(f"trace_exact: seg must be a positive step count, got {seg}")
    grad_needed = torch.is_grad_enabled() and rif.requires_grad
    return _TraceExact.apply(rif, x, v, float(h), float(ds), int(seg), grad_needed)


# ---------------------------------------------------------------------------
# trace_cable_exact: the cylinder (radial profile)
# ---------------------------------------------------------------------------

def _fwd_ckpts_cable(field: C.CylinderField, x0, v0, target, ds: float, max_steps: int,
                     seg: int, store_ckpts: bool = True, stats: Optional[dict] = None):
    """Segmented cable forward; returns ``(xt, vt, d2, c, ckpts)``.

    ``ckpts`` is the ``(nseg, 7, N)`` stack of ``(x, v, esc)`` at each segment
    start, one field of all the rays to a row, as K9 writes it (``None``
    unless ``store_ckpts``); ``c`` (int32) the step whose state became the
    closest approach, 0 if the ray never came closer than its start.  A
    segment is skipped once every ray has frozen.  ``stats`` gets
    ``ray_steps``: the steps of lanes still active.
    """
    nseg = -(-max_steps // seg)
    ds_t = G._scalar(ds, x0)
    x, v, xt, vt = x0, v0, x0, v0
    inside = C.cyl_inbounds(field, x0)
    esc = torch.zeros_like(inside)
    d2 = E.sum_sq3(x0 - target)
    c = torch.zeros((x0.shape[0],), dtype=torch.int32, device=x0.device)
    ckpts = []
    ray_steps = 0
    for s in range(nseg):
        if store_ckpts:
            ckpts.append(torch.cat([x.T, v.T, esc.to(x.dtype)[None]]))
        if bool(esc.all()):
            continue
        for j in range(min(seg, max_steps - s * seg)):
            if stats is not None:
                ray_steps += int((~esc).sum())
            x, v, cur_d2, inside, esc = E.cable_advance(field, x, v, inside, esc, target, ds_t)
            closer = cur_d2 < d2
            xt = _where3(closer, x, xt)
            vt = _where3(closer, v, vt)
            d2 = torch.where(closer, cur_d2, d2)
            c = torch.where(closer, s * seg + j + 1, c)
    if stats is not None:
        stats["ray_steps"] = ray_steps
    return xt, vt, d2, c, (torch.stack(ckpts) if store_ckpts else None)


def _bwd_segments_cable(field: C.CylinderField, ckpts, c, dx, dv, ds: float, seg: int,
                        acc_dtype: Optional[torch.dtype] = None,
                        out: Optional[torch.Tensor] = None, stats: Optional[dict] = None):
    """Replay the cable segments in reverse; the ``la``/``mu`` recursion gated
    by ``(k < c) & active_k``, segments at or past ``max(c)`` skipped.

    Returns the ``(res,)`` profile gradient summed in ``acc_dtype`` (default:
    the profile's), added into ``out`` when given.  ``stats`` gets
    ``ray_steps``: the gated-on steps (each a replayed step, an evaluation,
    a splat and an adjoint step).
    """
    nseg = ckpts.shape[0]
    ds_t = G._scalar(ds, dx)
    la = dx
    mu = dv + ds_t * dx
    g = out if out is not None else torch.zeros(
        field.data.shape, dtype=acc_dtype or field.data.dtype, device=field.data.device)
    max_c = int(c.max()) if c.numel() else 0
    ray_steps = 0
    for s in range(nseg - 1, -1, -1):
        if s * seg >= max_c:
            continue  # past every ray's capture step
        x, v = ckpts[s, :3].T.contiguous(), ckpts[s, 3:6].T.contiguous()
        esc = ckpts[s, 6] > 0.5
        xs, act = [], []
        for _ in range(seg):  # the forward positions of the segment
            active = ~esc
            inside = C.cyl_inbounds(field, x)
            x2, v2 = E.cable_step(field, x, v, active, ds_t)
            cur_inside = C.cyl_inbounds(field, x2)
            esc = esc | (inside & ~cur_inside) | C.cyl_escaped(field, x2, v2)
            xs.append(x)
            act.append(active)
            x, v = x2, v2
        for j in range(seg - 1, -1, -1):
            xk = xs[j]
            gate = ((s * seg + j) < c) & act[j]
            n, nx = C.cyl_eval_grad(field, xk, gate)
            hess = C.cyl_eval_hess(field, xk, gate)
            dn = (mu[:, 0] * nx[:, 0] + mu[:, 1] * nx[:, 1]) + mu[:, 2] * nx[:, 2]
            dnx = n[:, None] * mu
            if stats is not None:
                ray_steps += int(gate.sum())
            C.cyl_scatter_into(g, field, xk, dn * ds_t, dnx * ds_t, gate)
            la2 = la + ds_t * (dn[:, None] * nx + n[:, None] * C.cyl_hess_matvec(hess, mu))
            mu2 = mu + ds_t * la2
            la = _where3(gate, la2, la)
            mu = _where3(gate, mu2, mu)
    if stats is not None:
        stats["ray_steps"] = stats.get("ray_steps", 0) + ray_steps
        stats["splats"] = stats["ray_steps"]
    return g


def backtrace_cable_plain(field: C.CylinderField, x, v, target, c, ckpts, dxt, dvt, ds: float,
                          seg: int = 32, acc_dtype: Optional[torch.dtype] = None,
                          stats: Optional[dict] = None):
    """The exact cable path's backward pass in plain torch: the profile gradient.

    ``x, v, target`` are the rays' start and targets ((N, 3) each); ``c,
    ckpts`` what :func:`_fwd_ckpts_cable` returned (``ckpts`` ``None`` above
    the chunk size: each chunk of ``ANRT_EXACT_CHUNK`` rays then recomputes
    its own).  ``stats`` sums :func:`_bwd_segments_cable`'s over the chunks.
    """
    steps = cable_steps(field.length, ds)
    g = torch.zeros(field.data.shape, dtype=acc_dtype or field.data.dtype,
                    device=field.data.device)
    for sl in _chunks(x.shape[0], 0 if ckpts is not None else exact_chunk_rays()):
        ck = ckpts
        if ck is None:
            ck = _fwd_ckpts_cable(field, x[sl], v[sl], target[sl], ds, steps, seg)[4]
        _bwd_segments_cable(field, ck, c[sl], dxt[sl], dvt[sl], ds, seg, out=g, stats=stats)
    return g


class _TraceCableExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rif, x, v, target, radius, length, ds, seg, grad_needed):
        rif, x, v = (t.detach().contiguous() for t in (rif, x, v))
        tgt = bcast_per_ray3(target.detach(), x)
        steps = cable_steps(length, ds)
        # checkpoints are kept only for a backward pass that will read them
        store = grad_needed and len(_chunks(x.shape[0], exact_chunk_rays())) == 1
        if rif.is_cuda:
            xt, vt, d2, c, ckpts = K.trace_cable_ckpt(rif, radius, length, x, v, tgt, ds, steps,
                                                      seg, store_ckpts=store)
        else:
            xt, vt, d2, c, ckpts = _fwd_ckpts_cable(C.CylinderField(rif, radius, length), x, v,
                                                    tgt, ds, steps, seg, store)
        ctx.save_for_backward(rif, x, v, tgt, c, ckpts)
        ctx.radius, ctx.length, ctx.ds, ctx.seg = radius, length, ds, seg
        return xt, vt, d2

    @staticmethod
    def backward(ctx, dxt, dvt, dd2):
        # the cotangent of dist2 is dropped, as the JAX rule drops it
        rif, x, v, tgt, c, ckpts = ctx.saved_tensors
        radius, length, ds, seg = ctx.radius, ctx.length, ctx.ds, ctx.seg
        dxt, dvt = dxt.contiguous(), dvt.contiguous()
        if rif.is_cuda:
            g = torch.zeros((rif.shape[0],), dtype=torch.float64, device=rif.device)
            steps = cable_steps(length, ds)
            for sl in _chunks(x.shape[0], 0 if ckpts is not None else exact_chunk_rays()):
                ck = ckpts
                if ck is None:  # recompute this chunk's checkpoints
                    ck = K.trace_cable_ckpt(rif, radius, length, x[sl], v[sl], tgt[sl], ds,
                                            steps, seg, exit_state=False)[4]
                K.backtrace_cable_exact(rif, radius, length, ck, c[sl], dxt[sl], dvt[sl], ds,
                                        seg, out=g)
            g = g.to(rif.dtype)
        else:
            g = backtrace_cable_plain(C.CylinderField(rif, radius, length), x, v, tgt, c, ckpts,
                                      dxt, dvt, ds, seg)
        return g, None, None, None, None, None, None, None, None


def trace_cable_exact(rif: torch.Tensor, radius: float, length: float, x: torch.Tensor,
                      v: torch.Tensor, target: torch.Tensor, ds: float, seg: int = 32):
    """Cylinder-volume trace whose gradient is the exact discrete adjoint.

    Same forward semantics as :func:`tracer.api.trace_cable` (the closest
    approach ``(xt, vt, dist2)``, equal to it bit for bit); the backward pass
    replays segments from checkpoints, so the gradient equals autograd
    through the plain stepper to rounding at any precision.  Only ``rif``
    gets a gradient and the cotangent of ``dist2`` is dropped.  Batches above
    ``ANRT_EXACT_CHUNK`` rays run the backward pass chunk by chunk.
    """
    _check_cable(rif, x, v, target, "trace_cable_exact")
    if int(seg) < 1:
        raise ValueError(f"trace_cable_exact: seg must be a positive step count, got {seg}")
    grad_needed = torch.is_grad_enabled() and rif.requires_grad
    return _TraceCableExact.apply(rif, x, v, target, float(radius), float(length), float(ds),
                                  int(seg), grad_needed)
