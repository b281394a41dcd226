"""Checkpointed-segment adjoint: the exact gradient of the volume trace.

Twin of ``adjointnonlinearraytracing_tpu/tracer/checkpointed.py``: the plain
volume trace (``trace_exact``), its plane, target and sdf variants
(``trace_plane_exact``, ``trace_target_exact``, ``trace_sdf_exact``) and the
cable (``trace_cable_exact``).

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

The variants (twins of the JAX hooks ``_make_volume_variant``) share the
stepper and the backward pass and differ in the "inside" rule that masks the
field (plane: in the grid and not past the ray's plane; sdf: ``sdf < 0``
read under the previous inside), the capture rule (the target: every step
that comes closer) and the horizon.  ``c`` starts at ``max_steps`` for the
plane, whose missed rays pass no gradient through ``xt`` or ``vt``, and at 0
for the target and the sdf.  The target steps until the last ray of the
whole batch has escaped (chunked or not: the chunks recompute with that
step, ``_target_stop_step``), an escaped ray going straight and still
captured.  The sdf follows the JAX forward's segment skip: a segment is
skipped once every ray of the JAX package's chunk of the batch has escaped,
so a ray that left the grid inside the sdf steps to the first segment
boundary after its chunk's last escape (:func:`_index_chunk_horizons`), and
its output depends on ``ANRT_EXACT_CHUNK``, as the JAX package's does.
Kernels: K15-K17 ``trace_{plane,target,sdf}_ckpt`` (``trace_fwd.cu``), K18
``backtrace_plane_exact`` and K19 ``backtrace_sdf_exact``
(``backtrace_exact.cu``), and K6 for the target.

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
from .api import (_check_cable, _check_per_ray3, _check_rays, _check_rif, bcast_per_ray3,
                  cable_steps, sdf_steps)


def _where3(m, a, b):
    return torch.where(m[:, None], a, b)


#: the volume variants: the plain trace and the plane, target and sdf ones
VARIANTS = ("plain", "plane", "target", "sdf")


def _make_volume_variant(field: G.GridField, variant: str, sdf: Optional[G.GridField] = None,
                         pln_o=None, pln_d=None, target=None):
    """The variant's "inside" rule ``inside_update(x2, inside)``: the eval mask
    of the step after the one that reached ``x2`` (twin of the JAX package's
    ``_make_volume_variant``; the capture rule is the forward pass's own: the
    inside->outside crossing, or for the target every step that comes
    closer).  Plain and target: ``inbounds``; plane: in the grid and not past
    the ray's plane; sdf: ``sdf < 0`` at ``x2``, read under ``inside`` (a ray
    outside reads 0 and stays outside)."""
    if variant in ("plain", "target"):
        return lambda x2, inside: G.inbounds(field, x2)
    if variant == "plane":
        return lambda x2, inside: E._plane_inside(field, x2, pln_o, pln_d)
    if variant == "sdf":
        return lambda x2, inside: G.eval_grad_plain(sdf, x2, inside)[0] < 0
    raise ValueError(f"unknown variant {variant!r}, expected one of {VARIANTS}")


def _forward_with_ckpts(field: G.GridField, x0, v0, ds: float, max_steps: int, seg: int,
                        store_ckpts: bool = True, stats: Optional[dict] = None,
                        variant: str = "plain", stop=None, **vargs):
    """Segmented forward; returns ``(xt, vt, esc, c, captured, ckpts)``.

    ``ckpts`` is the ``(nseg, 7, N)`` stack of ``(x, v, inside)`` at each
    segment start, one field of all the rays to a row, as K5 writes it
    (``None`` when ``store_ckpts`` is false); ``c`` (int32) the
    capture step; ``captured`` whether the ray was ever captured.  A ray
    that escaped without being captured was never inside (a ray that was
    inside leaves only by crossing), so its gradient is zero.  ``stats`` as
    for ``eikonal.trace``: ``ray_steps`` of the rays a kernel steps (not yet
    escaped; for the target every ray while the batch runs, for the sdf also
    the escaped rays still inside it) and ``evals`` of those inside.

    ``variant`` (:data:`VARIANTS`) with its ``vargs`` (``pln_o, pln_d``;
    ``target``; ``sdf``, a ``GridField``) as for :func:`_make_volume_variant`.
    ``c`` starts at ``max_steps`` for the plain and plane variants, whose rays
    that never escaped report their last position; at 0 for the target and
    the sdf.  A segment is skipped once every ray has escaped, and the target
    steps only while some ray has not (the JAX per-step gate ``~all(esc)``).
    ``stop`` (an int ``(N,)`` tensor) sets each ray's horizon instead: a ray
    takes no step ``k >= stop``.  The target's is the whole batch's last
    escape step (:func:`_target_stop_step`: a chunk of the batch steps as the
    whole batch does), the sdf's its JAX chunk's (:func:`_index_chunk_horizons`).
    The target's closest squared distance is ``eikonal.sum_sq3(xt - target)``,
    bit for bit.
    """
    nseg = -(-max_steps // seg)
    n = x0.shape[0]
    ds_t = G._scalar(ds, x0)
    inside_update = _make_volume_variant(field, variant, **vargs)
    target = vargs.get("target")
    x, v, xt, vt = x0, v0, x0, v0
    inside = G.inbounds(field, x0)
    esc = torch.zeros_like(inside)
    captured = torch.zeros_like(inside)
    c = torch.full((n,), max_steps if variant in ("plain", "plane") else 0, dtype=torch.int32,
                   device=x0.device)
    d2 = E.sum_sq3(x0 - target) if variant == "target" else None
    ckpts = []
    ray_steps = evals = 0
    for s in range(nseg):
        if store_ckpts:
            ckpts.append(torch.cat([x.T, v.T, inside.to(x.dtype)[None]]))
        if bool(esc.all() if stop is None else (stop <= s * seg).all()):
            continue
        for j in range(min(seg, max_steps - s * seg)):
            k = s * seg + j
            run = None if stop is None else k < stop
            if variant == "target" and bool(esc.all() if run is None else ~run.any()):
                break  # the batch's horizon: no ray steps from here on
            if stats is not None:
                moving = ~esc
                if variant == "target":
                    moving = torch.ones_like(esc)
                elif variant == "sdf":
                    moving = ~esc | inside
                if run is not None:
                    moving = moving & run
                ray_steps += int(moving.sum())
                evals += int((inside & moving).sum())
            x2, v2 = E.forward_step(field, x, v, inside, ds_t)
            cur = inside_update(x2, inside)
            cross = inside & ~cur
            esc2 = esc | cross | G.escaped(field, x2, v2)
            if variant == "target":
                cur_d2 = E.sum_sq3(x2 - target)
                cap = cur_d2 < d2
                d2 = torch.where(cap, cur_d2, d2)
            else:
                cap = cross
            if run is not None:
                x2, v2 = _where3(run, x2, x), _where3(run, v2, v)
                cur = torch.where(run, cur, inside)
                esc2 = torch.where(run, esc2, esc)
                cap = cap & run
            x, v, esc, inside = x2, v2, esc2, cur
            xt = _where3(cap, x, xt)
            vt = _where3(cap, v, vt)
            c = torch.where(cap, k + 1, c)
            captured = captured | cap
    if variant in ("plain", "plane"):
        xt = _where3(esc, xt, x)  # failed-to-exit fix-up: report the final position
    if stats is not None:
        stats["ray_steps"] = ray_steps
        stats["evals"] = evals
    return xt, vt, esc, c, captured, (torch.stack(ckpts) if store_ckpts else None)


def _backward_segments(field: G.GridField, ckpts, c, dx, dv, ds: float, seg: int,
                       acc_dtype: Optional[torch.dtype] = None,
                       stats: Optional[dict] = None, out: Optional[torch.Tensor] = None,
                       variant: str = "plain", **vargs):
    """Replay the segments in reverse; the exact ``la``/``mu`` recursion gated on ``k < c``.

    The replay takes the forward's step and the variant's "inside" rule
    (:func:`_make_volume_variant`, ``vargs`` as there), so every position
    and eval mask is the forward's.  Returns the flat voxel gradient, summed
    in ``acc_dtype`` (default: the field's; float64 sums the same float32
    terms as a reference), added into ``out`` when given.  ``stats`` gets
    ``ray_steps`` (gated-on steps of the rays whose gradient is not zero: each
    is a replayed step and a backward step), ``evals`` (those inside: each
    evaluates and splats) and ``flushes``, the runs of splats as
    ``eikonal.backtrace`` counts them.
    """
    nseg = ckpts.shape[0]
    ds_t = G._scalar(ds, dx)
    inside_update = _make_volume_variant(field, variant, **vargs)
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
            x, v = E.forward_step(field, x, v, inside, ds_t)
            inside = inside_update(x, inside)
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


def variant_steps(variant: str, rif_shape, h: float, ds: float) -> int:
    """A variant's step bound: ``api.sdf_steps`` for the sdf, else
    ``eikonal.max_steps_fwd``."""
    if variant == "sdf":
        return sdf_steps(rif_shape, h, ds)
    return E.max_steps_fwd(max(rif_shape), h, ds)


def _slice_vargs(vargs: dict, sl: slice, n: int) -> dict:
    """The per-ray arguments (``(N, ...)`` tensors) of the rays ``sl``; the rest as given."""
    return {k: a[sl] if isinstance(a, torch.Tensor) and a.shape[:1] == (n,) else a
            for k, a in vargs.items()}


def backtrace_plain(rif, x, v, esc, c, ckpts, dxt, dvt, h: float, ds: float, seg: int = 32,
                    acc_dtype: Optional[torch.dtype] = None, stats: Optional[dict] = None,
                    variant: str = "plain", stop=None, **vargs):
    """The exact path's backward pass in plain torch: the flat voxel gradient.

    ``x, v`` are the rays' start; ``esc, c, ckpts`` what
    :func:`_forward_with_ckpts` returned (``ckpts`` ``None`` above the chunk
    size).  Without checkpoints, each chunk of ``ANRT_EXACT_CHUNK`` rays
    recomputes its own, with the forward's ``stop`` (needed for the target
    and the sdf: their horizon is the batch's or the JAX chunk's, not the
    chunk's).  ``variant`` and ``vargs`` as for :func:`_forward_with_ckpts`;
    the plain and plane variants zero the ``vt`` cotangent of the rays that
    never escaped (their ``vt`` is ``v0``).  ``stats`` sums
    :func:`_backward_segments`'s over the chunks and needs the forward's
    ``captured`` under the key ``"captured"``.
    """
    field = G.GridField(rif, h)
    steps = variant_steps(variant, rif.shape, h, ds)
    if variant in ("plain", "plane"):  # vt of a never-exited ray is v0
        dvt = torch.where(esc[:, None], dvt, torch.zeros_like(dvt))
    g = torch.zeros((rif.numel(),), dtype=acc_dtype or rif.dtype, device=rif.device)
    captured = None if stats is None else stats.pop("captured")
    totals = {}
    n = x.shape[0]
    for sl in _chunks(n, 0 if ckpts is not None else exact_chunk_rays()):
        va = _slice_vargs(vargs, sl, n)
        if ckpts is None:
            _, _, esc_c, c_c, cap_c, ck = _forward_with_ckpts(
                field, x[sl], v[sl], ds, steps, seg, variant=variant,
                stop=None if stop is None else stop[sl], **va)
        else:
            esc_c, c_c, cap_c, ck = esc, c, captured, ckpts
        st = None
        if stats is not None:
            st = {"live": cap_c | ~esc_c}
        _backward_segments(field, ck, c_c, dxt[sl], dvt[sl], ds, seg, stats=st, out=g,
                           variant=variant, **va)
        for k, val in (st or {}).items():
            totals[k] = totals.get(k, 0) + val
    if stats is not None:
        stats.update(totals)
    return g


def _escape_steps(field: G.GridField, x0, v0, ds: float, max_steps: int, variant: str = "plain",
                  **vargs):
    """Each ray's escape step (int32): the step ``k + 1`` at which ``esc`` first
    became true, ``max_steps`` for a ray that never escaped; under the
    variant's "inside" rule (twin of the JAX ``_escape_steps``, which takes
    the plain rule, the target's too).  Escape does not depend on the
    capture, so the batch's horizon is the maximum over any split of it."""
    inside_update = _make_volume_variant(field, variant, **vargs)
    ds_t = G._scalar(ds, x0)
    x, v = x0, v0
    inside = G.inbounds(field, x0)
    esc = torch.zeros_like(inside)
    e = torch.full((x0.shape[0],), max_steps, dtype=torch.int32, device=x0.device)
    step = 0
    while step < max_steps and not bool(esc.all()):
        x, v = E.forward_step(field, x, v, inside, ds_t)
        cur = inside_update(x, inside)
        esc2 = esc | (inside & ~cur) | G.escaped(field, x, v)
        e = torch.where(esc2 & ~esc, step + 1, e)
        esc, inside = esc2, cur
        step += 1
    return e


def _index_chunk_horizons(esc_steps: torch.Tensor, chunk: int, seg: int,
                          max_steps: int) -> torch.Tensor:
    """The sdf variant's horizon of every ray (int32 ``(N,)``), from each ray's
    escape step (:func:`_escape_steps`).

    The JAX package's exact forward skips a segment once every ray of its
    chunk has escaped and steps on to the segment's end: a ray steps up to
    the first segment boundary at or after the last escape of its chunk,
    capped at ``max_steps``.  The chunks are its own (``_to_chunks``): runs of
    ``chunk`` ray indices (the whole batch when ``chunk`` is 0 or not below
    ``N``), the last one padded with copies of ray 0.
    """
    n = esc_steps.shape[0]
    if not chunk or n <= chunk:
        chunk = max(n, 1)
    nc = -(-n // chunk)
    e = esc_steps.to(torch.int64)
    e = torch.cat([e, e[:1].expand(nc * chunk - n)]).view(nc, chunk).amax(dim=1)
    last = torch.clamp(-(-e // seg) * seg, max=int(max_steps))
    return last.repeat_interleave(chunk)[:n].to(torch.int32).contiguous()


def _target_stop_step(field: G.GridField, x, v, ds: float, max_steps: int, chunk: int) -> int:
    """The target's horizon over the whole batch, the last ray's escape step,
    taken chunk by chunk (twin of the JAX ``_target_stop_step``; the copies
    of ray 0 that pad its last chunk change no maximum)."""
    if not x.shape[0]:
        return 0
    return max(int(_escape_steps(field, x[sl], v[sl], ds, max_steps).max())
               for sl in _chunks(x.shape[0], chunk))


class _TraceExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rif, x, v, h, ds, seg, keep_ckpts):
        rif, x, v = (t.detach().contiguous() for t in (rif, x, v))
        steps = E.max_steps_fwd(max(rif.shape), h, ds)
        # checkpoints are kept only for a backward pass that will read them,
        # and only where the caller lets them be (the sharded trace of
        # parallel/mesh.py keeps none: its backward pass recomputes them)
        store = keep_ckpts and len(_chunks(x.shape[0], exact_chunk_rays())) == 1
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
# trace_plane_exact, trace_target_exact, trace_sdf_exact: the volume variants
# ---------------------------------------------------------------------------

class _TraceVariantExact(torch.autograd.Function):
    """The three variants' exact gradients: ``(rif, sdf, x, v, pa, pb)`` with
    ``pa, pb`` the plane's origin and normal, the target (``pb`` None), or
    neither (the sdf, given as ``sdf``)."""

    @staticmethod
    def forward(ctx, rif, sdf, x, v, pa, pb, h, ds, seg, variant, grad_needed, stop_all=None):
        # stop_all (the target only): a function of this batch's horizon, an
        # int32 (1,) tensor, that returns the horizon to step to (the sharded
        # exact target's maximum over the ranks); called on every call
        rif, x, v = (t.detach().contiguous() for t in (rif, x, v))
        o = d = tgt = None
        if variant == "plane":
            o, d = bcast_per_ray3(pa.detach(), x), bcast_per_ray3(pb.detach(), x)
        elif variant == "target":
            tgt = bcast_per_ray3(pa.detach(), x)
        else:
            sdf = sdf.detach().contiguous()
        steps = variant_steps(variant, rif.shape, h, ds)
        chunk = exact_chunk_rays()
        chunked = len(_chunks(x.shape[0], chunk)) > 1
        # checkpoints are kept only for a backward pass that will read them
        store = grad_needed and not chunked
        d2 = miss = stop = None
        if rif.is_cuda:
            order = O.ray_order(x, v, rif.shape, h)
            if variant == "plane":
                xt, vt, miss, c, code, ckpts = K.trace_plane_ckpt(rif, h, x, v, o, d, ds, steps,
                                                                  seg, order, store)
            elif variant == "target":
                xt, vt, d2, c, code, ckpts, stop = K.trace_target_ckpt(rif, h, x, v, tgt, ds,
                                                                       steps, seg, order, store,
                                                                       horizon=stop_all)
            else:
                xt, vt, c, code, ckpts, stop = K.trace_sdf_ckpt(
                    rif, sdf, h, x, v, ds, steps, seg, order, chunk if chunked else 0, store)
            esc = code != 0
        else:
            order = code = None
            field = G.GridField(rif, h)
            va = _variant_args(variant, h, o, d, tgt, sdf)
            if variant == "target" and (chunked or stop_all is not None):
                last = torch.tensor([_target_stop_step(field, x, v, ds, steps, chunk)],
                                    dtype=torch.int32)
                if stop_all is not None:
                    last = stop_all(last)
                stop = torch.full((x.shape[0],), int(last), dtype=torch.int32)
            elif chunked and variant == "sdf":
                stop = _index_chunk_horizons(
                    _escape_steps(field, x, v, ds, steps, variant="sdf", **va), chunk, seg, steps)
            xt, vt, esc, c, _, ckpts = _forward_with_ckpts(field, x, v, ds, steps, seg, store,
                                                           variant=variant, stop=stop, **va)
            miss = ~esc
            if variant == "target":
                d2 = E.sum_sq3(xt - tgt)
        ctx.save_for_backward(rif, sdf, x, v, o, d, tgt, esc, c, code, ckpts, order, stop)
        ctx.h, ctx.ds, ctx.seg, ctx.variant = h, ds, seg, variant
        # the plane and the target as the caller gave them ((3,), (1, 3) or (N, 3))
        ctx.given = [None if p is None else (p.shape, p.dtype, p.device) for p in (pa, pb)]
        if variant == "plane":
            ctx.mark_non_differentiable(miss)
            return xt, vt, miss
        if variant == "target":
            ctx.mark_non_differentiable(d2)
            return xt, vt, d2
        return xt, vt

    @staticmethod
    def backward(ctx, dxt, dvt, *_):
        # the cotangents of miss and d2 are dropped
        rif, sdf, x, v, o, d, tgt, esc, c, code, ckpts, order, stop = ctx.saved_tensors
        h, ds, seg, variant = ctx.h, ctx.ds, ctx.seg, ctx.variant
        dxt, dvt = dxt.contiguous(), dvt.contiguous()
        if variant == "plane":
            # a missed ray passes no position cotangent, and its vt is v0
            dxt = torch.where(esc[:, None], dxt, torch.zeros_like(dxt))
            dvt = torch.where(esc[:, None], dvt, torch.zeros_like(dvt))
        if rif.is_cuda:
            steps = variant_steps(variant, rif.shape, h, ds)
            # K19 sums in float64 whatever the grid's type
            g = torch.zeros((rif.numel(),), device=rif.device,
                            dtype=torch.float64 if variant == "sdf" else rif.dtype)
            for sl in _chunks(x.shape[0], 0 if ckpts is not None else exact_chunk_rays()):
                ck = ckpts
                if variant == "plane":
                    if ck is None:  # recompute this chunk's checkpoints
                        ck = K.trace_plane_ckpt(rif, h, x, v, o, d, ds, steps, seg, order[sl])[5]
                    K.backtrace_plane_exact(rif, h, ck, c, code, o, d, dxt, dvt, ds, seg,
                                            order[sl], out=g)
                elif variant == "target":
                    if ck is None:
                        ck = K.trace_target_ckpt(rif, h, x, v, tgt, ds, steps, seg, order[sl],
                                                 horizon=stop)[5]
                    K.backtrace_exact(rif, h, ck, c, code, dxt, dvt, ds, seg, order[sl], out=g)
                else:
                    if ck is None:
                        ck = K.trace_sdf_ckpt(rif, sdf, h, x, v, ds, steps, seg, order[sl],
                                              stop)[4]
                    K.backtrace_sdf_exact(rif, sdf, h, ck, c, code, dxt, dvt, ds, seg, order[sl],
                                          out=g)
        else:
            g = backtrace_plain(rif, x, v, esc, c, ckpts, dxt, dvt, h, ds, seg, variant=variant,
                                stop=stop, **_variant_args(variant, h, o, d, tgt, sdf))
        need = ctx.needs_input_grad
        zeros = [torch.zeros_like(t) if t is not None and need[k] else None
                 for k, t in ((1, sdf), (2, x), (3, v))]
        zeros += [torch.zeros(p[0], dtype=p[1], device=p[2]) if p is not None and need[k] else None
                  for k, p in zip((4, 5), ctx.given)]
        return (g.to(rif.dtype).reshape(rif.shape), *zeros, None, None, None, None, None, None)


def _variant_args(variant, h, o, d, tgt, sdf) -> dict:
    """The ``vargs`` of :func:`_forward_with_ckpts` for ``variant``."""
    if variant == "plane":
        return dict(pln_o=o, pln_d=d)
    if variant == "target":
        return dict(target=tgt)
    return dict(sdf=G.GridField(sdf, h))


def _variant_exact(variant, rif, sdf, x, v, pa, pb, h, ds, seg, stop_all=None):
    name = f"trace_{variant}_exact"
    _check_rif(rif, name)
    _check_rays(x, v, name)
    for label, p in zip({"plane": ("pln_o", "pln_d"), "target": ("target",)}.get(variant, ()),
                        (pa, pb)):
        _check_per_ray3(p, x, label, name)
    if sdf is not None and sdf.shape != rif.shape:
        raise ValueError(f"{name}: sdf grid {tuple(sdf.shape)} must match rif {tuple(rif.shape)}")
    if int(seg) < 1:
        raise ValueError(f"{name}: seg must be a positive step count, got {seg}")
    grad_needed = torch.is_grad_enabled() and rif.requires_grad
    return _TraceVariantExact.apply(rif, sdf, x, v, pa, pb, float(h), float(ds), int(seg),
                                    variant, grad_needed, stop_all)


def trace_plane_exact(rif: torch.Tensor, x: torch.Tensor, v: torch.Tensor, pln_o: torch.Tensor,
                      pln_d: torch.Tensor, h: float, ds: float, seg: int = 32):
    """Plane-terminated trace whose gradient is the exact discrete adjoint.

    Same forward semantics as :func:`tracer.api.trace_plane`: returns ``(xt,
    vt, miss)``, ``pln_o, pln_d`` ``(N, 3)`` or one plane for every ray.  The
    backward pass zeroes both cotangents of the rays that missed (their
    ``vt`` is the untouched ``v0``: autograd's own gradient), where
    ``trace_plane`` zeroes only the position's.  Only ``rif`` gets a
    gradient; ``x``, ``v`` and the plane zeros.  Batches above
    ``ANRT_EXACT_CHUNK`` rays run the backward pass chunk by chunk.  Kernels
    on the card: K15 forward, K18 backward.
    """
    return _variant_exact("plane", rif, None, x, v, pln_o, pln_d, h, ds, seg)


def trace_target_exact(rif: torch.Tensor, x: torch.Tensor, v: torch.Tensor, target: torch.Tensor,
                       h: float, ds: float, seg: int = 32):
    """Closest-approach trace whose gradient is the exact discrete adjoint.

    Same forward semantics as :func:`tracer.api.trace_target`: returns ``(xt,
    vt, d2)``; the rays step on (straight, once escaped) until the last ray
    of the whole batch has escaped, however the backward pass chunks it.
    ``d2`` carries no gradient; only ``rif`` gets one, ``x``, ``v`` and the
    target zeros.  Kernels on the card: K16 forward, K6 backward.
    """
    return _variant_exact("target", rif, None, x, v, target, None, h, ds, seg)


def trace_sdf_exact(rif: torch.Tensor, sdf: torch.Tensor, x: torch.Tensor, v: torch.Tensor,
                    h: float, ds: float, seg: int = 32):
    """SDF-interior trace whose gradient is the exact discrete adjoint.

    The forward semantics of the JAX package's ``trace_sdf_exact``: those of
    :func:`tracer.api.trace_sdf`, ``int(2 * h * max(res) / ds)`` steps, but
    a ray that left the grid while still inside the sdf stops stepping at the
    first segment boundary at or after the last escape of its chunk of the
    batch (``ANRT_EXACT_CHUNK`` rays, the whole batch below it; see
    :func:`_index_chunk_horizons`), where ``trace_sdf`` steps
    it to the batch's last escape step: a crossing after either horizon
    differs between the two.  Returns ``(xt, vt)``; only
    ``rif`` gets a gradient, the sdf, ``x`` and ``v`` zeros.  Kernels on the
    card: K17 forward, K19 backward.
    """
    return _variant_exact("sdf", rif, sdf, x, v, None, None, h, ds, seg)


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
