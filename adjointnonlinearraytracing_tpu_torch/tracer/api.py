"""Differentiable tracing API: ``trace``, the variants ``trace_plane``,
``trace_target``, ``trace_sdf`` and ``trace_cable`` as
``torch.autograd.Function`` classes whose backward pass is the constant-memory
adjoint sweep, and their taped twins ``trace_ad``, ``trace_plane_ad``,
``trace_target_ad``, ``trace_sdf_ad`` and ``trace_cable_ad``.

Twin of the functions of these names in
``adjointnonlinearraytracing_tpu/tracer/api.py``.

Gradient contract: only the field data ``rif`` receives a gradient; the ray
inputs ``x``, ``v``, the planes and targets get none, ``miss`` and ``d2``
carry none, and the sdf grid of ``trace_sdf`` gets a zero cotangent.
``trace_plane``'s backward zeroes the position cotangent of the rays that
missed (never escaped).  ``h`` and ``ds`` are Python floats.

Where it runs: CUDA tensors go through the hand-written kernels
(``kernels/csrc/trace_fwd.cu``, ``kernels/csrc/backtrace.cu``: K2 and K3; the
variants K11-K13 forward, K3 backward for the plane and target, K14 for the
sdf; for the cable, ``trace_cable.cu`` and ``backtrace_cable.cu``) or raise;
CPU tensors go through the plain steppers of ``tracer/eikonal.py``.  There is no
fallback from one to the other.  On the card the forward pass first puts the
rays in a coherent order (``tracer/order.py``), hands it to K2 and keeps it for
K3 in the backward pass; outputs are in the caller's order, and the CPU path
takes the rays as they come.

What is not here: the JAX package chooses between a paired-window stepper and
a cell-table stepper (``_impl`` with ``ANRT_FAST_PATH``, ``ANRT_NMAX``,
``ANRT_WINDOW_MEM_MB``).  Both tables exist because its compiler had no
per-lane gather and no scatter-add; on this GPU the kernels read the 8 corners
of a cell from the raw grid and scatter with ``atomicAdd``, so there is one
path and no table, and those settings have no counterpart.

Determinism: on the CPU the gradient is reproducible bitwise
(``index_add_``); on the GPU the adjoint's ``atomicAdd`` order varies from run
to run, so the gradient is reproducible to rounding only.

Precision: the constant-memory adjoint re-integrates trajectories in reverse;
at float32 the reconstruction drifts on rough (high-curvature) index fields
and the gradient error grows with field roughness.  Use float64 inputs when
optimizing non-smooth fields.
"""

from __future__ import annotations

import torch

from ..fields import cylinder as C
from ..fields import grid as G
from ..kernels import wrappers as K
from . import eikonal as E
from . import order as O


def _check_rays(x, v, name="trace"):
    if x.ndim != 2 or x.shape[-1] != 3:
        raise ValueError(f"{name}: x must be (N, 3), got {tuple(x.shape)}")
    if v.shape != x.shape:
        raise ValueError(f"{name}: v{tuple(v.shape)} must match x{tuple(x.shape)}")


def _check_rif(rif, name="trace"):
    if rif.ndim != 3:
        raise ValueError(
            f"{name}: rif must be a 3D voxel grid, got shape {tuple(rif.shape)}")


def _forward_order(rif, x, v, h):
    """The ray order the card's forward pass makes and its backward keeps; None on the CPU."""
    return O.ray_order(x, v, rif.shape, h) if rif.is_cuda else None


def _adjoint(rif, h, ds, xt, vt, dxt, dvt, order, sdf=None):
    """The flat voxel gradient by the adjoint sweep: K3 (K14 with ``sdf``) on the
    card, the plain sweep on the CPU."""
    steps = E.max_steps_bwd(max(rif.shape), h, ds)
    dxt, dvt = dxt.contiguous(), dvt.contiguous()
    if rif.is_cuda:
        if sdf is None:
            return K.backtrace(rif, h, xt, vt, dxt, dvt, ds, steps, G.snap_tol(rif.dtype), order)
        return K.backtrace_sdf(rif, sdf, h, xt, vt, dxt, dvt, ds, steps, G.snap_tol(rif.dtype),
                               order).to(rif.dtype)
    field = G.GridField(rif, h)
    if sdf is None:
        return E.backtrace(field, xt, vt, dxt, dvt, ds, steps)
    return E.backtrace_sdf(field, G.GridField(sdf, h), xt, vt, dxt, dvt, ds, steps)


class _Trace(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rif, x, v, h, ds):
        # the kernels take contiguous tensors; the CPU path takes any strides,
        # and the same call must work on both
        rif, x, v = (t.detach().contiguous() for t in (rif, x, v))
        steps = E.max_steps_fwd(max(rif.shape), h, ds)
        order = _forward_order(rif, x, v, h)
        if rif.is_cuda:
            xt, vt = K.trace_fwd(rif, h, x, v, ds, steps, order)
        else:
            xt, vt = E.trace(G.GridField(rif, h), x, v, ds, steps)
        ctx.save_for_backward(rif, xt, vt, order)
        ctx.h, ctx.ds = h, ds
        return xt, vt

    @staticmethod
    def backward(ctx, dxt, dvt):
        rif, xt, vt, order = ctx.saved_tensors
        g = _adjoint(rif, ctx.h, ctx.ds, xt, vt, dxt, dvt, order)
        return g.reshape(rif.shape), None, None, None, None


def trace(rif: torch.Tensor, x: torch.Tensor, v: torch.Tensor, h: float, ds: float):
    """Differentiable volume trace.  rif: (D,H,W) voxel grid; x, v: (N,3).

    Returns the exit state ``(xt, vt)``.  d(loss)/d(rif) is computed by the
    constant-memory adjoint; ``x`` and ``v`` receive no gradient.
    """
    _check_rif(rif)
    _check_rays(x, v)
    return _Trace.apply(rif, x, v, float(h), float(ds))


def trace_ad(rif: torch.Tensor, x: torch.Tensor, v: torch.Tensor, h: float, ds: float):
    """Tape twin of :func:`trace`: autograd straight through the plain stepper.

    Twin of the JAX package's ``trace_ad``.  The exact discrete gradient, with
    memory that grows with the step count; used for cross-validation
    (``make_trace``'s ``"ad"`` mode) and as the exact reference of the
    gradient spot check.  It runs ``tracer.eikonal.trace`` where its tensors
    live, on the card too: it is the taped plain version by definition, not a
    fallback of :func:`trace`, and launches no kernel.  ``rif``, ``x`` and
    ``v`` all receive gradients.
    """
    _check_rif(rif, "trace_ad")
    _check_rays(x, v, "trace_ad")
    h, ds = float(h), float(ds)
    return E.trace(G.GridField(rif, h), x, v, ds, E.max_steps_fwd(max(rif.shape), h, ds))


def _check_per_ray3(arr, x, label, name):
    """A per-ray 3-vector input: (N, 3) matching x, or broadcastable (1, 3) / (3,)."""
    if arr.shape[-1] != 3 or arr.ndim > 2:
        raise ValueError(f"{name}: {label} must be (N, 3) or (3,), got {tuple(arr.shape)}")
    if arr.ndim == 2 and arr.shape[0] not in (1, x.shape[0]):
        raise ValueError(f"{name}: {label} has {arr.shape[0]} rows but x has "
                         f"{x.shape[0]} rays")


def bcast_per_ray3(arr, x):
    """An accepted (3,) / (1, 3) / (N, 3) per-ray vector as a contiguous (N, 3)."""
    a = arr[None] if arr.ndim == 1 else arr
    return a.expand(x.shape[0], 3).contiguous()


class _TracePlane(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rif, x, v, pln_o, pln_d, h, ds):
        rif, x, v = (t.detach().contiguous() for t in (rif, x, v))
        o, d = bcast_per_ray3(pln_o.detach(), x), bcast_per_ray3(pln_d.detach(), x)
        steps = E.max_steps_fwd(max(rif.shape), h, ds)
        order = _forward_order(rif, x, v, h)
        if rif.is_cuda:
            xt, vt, miss = K.trace_plane(rif, h, x, v, o, d, ds, steps, order)
        else:
            xt, vt, miss = E.trace_plane(G.GridField(rif, h), x, v, o, d, ds, steps)
        ctx.mark_non_differentiable(miss)
        ctx.save_for_backward(rif, xt, vt, miss, order)
        ctx.h, ctx.ds = h, ds
        return xt, vt, miss

    @staticmethod
    def backward(ctx, dxt, dvt, dmiss):
        rif, xt, vt, miss, order = ctx.saved_tensors
        # the rays that missed pass no position cotangent (their velocity one stays)
        dxt = torch.where(miss[:, None], torch.zeros_like(dxt), dxt)
        g = _adjoint(rif, ctx.h, ctx.ds, xt, vt, dxt, dvt, order)
        return g.reshape(rif.shape), None, None, None, None, None, None


def trace_plane(rif: torch.Tensor, x: torch.Tensor, v: torch.Tensor, pln_o: torch.Tensor,
                pln_d: torch.Tensor, h: float, ds: float):
    """Trace stopping past each ray's plane (``pln_o``, ``pln_d``: ``(N, 3)`` or
    ``(3,)`` / ``(1, 3)`` for every ray); returns ``(xt, vt, miss)``.

    ``miss`` marks the rays that never exited; the backward pass zeroes their
    position cotangent.  Only ``rif`` gets a gradient (the adjoint, K3 on the
    card; the forward pass is K11)."""
    _check_rif(rif, "trace_plane")
    _check_rays(x, v, "trace_plane")
    _check_per_ray3(pln_o, x, "pln_o", "trace_plane")
    _check_per_ray3(pln_d, x, "pln_d", "trace_plane")
    return _TracePlane.apply(rif, x, v, pln_o, pln_d, float(h), float(ds))


class _TraceTarget(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rif, x, v, target, h, ds):
        rif, x, v = (t.detach().contiguous() for t in (rif, x, v))
        tgt = bcast_per_ray3(target.detach(), x)
        steps = E.max_steps_fwd(max(rif.shape), h, ds)
        order = _forward_order(rif, x, v, h)
        if rif.is_cuda:
            xt, vt, d2 = K.trace_target(rif, h, x, v, tgt, ds, steps, order)
        else:
            xt, vt, d2 = E.trace_target(G.GridField(rif, h), x, v, tgt, ds, steps)
        ctx.mark_non_differentiable(d2)
        ctx.save_for_backward(rif, xt, vt, order)
        ctx.h, ctx.ds = h, ds
        return xt, vt, d2

    @staticmethod
    def backward(ctx, dxt, dvt, dd2):
        rif, xt, vt, order = ctx.saved_tensors
        g = _adjoint(rif, ctx.h, ctx.ds, xt, vt, dxt, dvt, order)
        return g.reshape(rif.shape), None, None, None, None, None


def trace_target(rif: torch.Tensor, x: torch.Tensor, v: torch.Tensor, target: torch.Tensor,
                 h: float, ds: float):
    """Trace recording each ray's closest approach to its ``target`` (``(N, 3)``,
    or ``(3,)`` / ``(1, 3)`` for every ray); returns ``(xt, vt, d2)``.

    A ray's result depends on its batch: the loop runs until the batch's last
    ray escapes (``eikonal.trace_target``).  ``d2`` carries no gradient; only
    ``rif`` gets one, by the adjoint from the closest-approach state (K12
    forward, K3 backward on the card)."""
    _check_rif(rif, "trace_target")
    _check_rays(x, v, "trace_target")
    _check_per_ray3(target, x, "target", "trace_target")
    return _TraceTarget.apply(rif, x, v, target, float(h), float(ds))


def sdf_steps(rif_shape, h: float, ds: float) -> int:
    """The sdf trace's step bound, ``int(2 * h * max(res) / ds)``."""
    return int(2.0 * h * max(rif_shape) / ds)


class _TraceSdf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rif, sdf, x, v, h, ds):
        rif, sdf, x, v = (t.detach().contiguous() for t in (rif, sdf, x, v))
        steps = sdf_steps(rif.shape, h, ds)
        order = _forward_order(rif, x, v, h)
        if rif.is_cuda:
            xt, vt = K.trace_sdf(rif, sdf, h, x, v, ds, steps, order)
        else:
            xt, vt = E.trace_sdf(G.GridField(rif, h), G.GridField(sdf, h), x, v, ds, steps)
        ctx.save_for_backward(rif, sdf, xt, vt, order)
        ctx.h, ctx.ds = h, ds
        return xt, vt

    @staticmethod
    def backward(ctx, dxt, dvt):
        rif, sdf, xt, vt, order = ctx.saved_tensors
        g = _adjoint(rif, ctx.h, ctx.ds, xt, vt, dxt, dvt, order, sdf=sdf)
        dsdf = torch.zeros_like(sdf) if ctx.needs_input_grad[1] else None
        return g.reshape(rif.shape), dsdf, None, None, None, None


def trace_sdf(rif: torch.Tensor, sdf: torch.Tensor, x: torch.Tensor, v: torch.Tensor,
              h: float, ds: float):
    """Trace where the medium is ``sdf < 0`` (``sdf``: a grid of ``rif``'s shape);
    returns ``(xt, vt)``.  The step bound is ``int(2 * h * max(res) / ds)``.

    Only ``rif`` gets a gradient (K13 forward, K14 backward on the card); the
    sdf's cotangent is zero."""
    _check_rif(rif, "trace_sdf")
    _check_rays(x, v, "trace_sdf")
    if sdf.shape != rif.shape:
        raise ValueError(f"trace_sdf: sdf grid {tuple(sdf.shape)} must match rif "
                         f"{tuple(rif.shape)}")
    return _TraceSdf.apply(rif, sdf, x, v, float(h), float(ds))


def trace_plane_ad(rif: torch.Tensor, x: torch.Tensor, v: torch.Tensor, pln_o: torch.Tensor,
                   pln_d: torch.Tensor, h: float, ds: float):
    """Tape twin of :func:`trace_plane`: autograd through the fixed-trip plain
    stepper (``eikonal.trace_plane_scan``) where its tensors live; no kernel."""
    _check_rif(rif, "trace_plane_ad")
    _check_rays(x, v, "trace_plane_ad")
    h, ds = float(h), float(ds)
    return E.trace_plane_scan(G.GridField(rif, h), x, v, bcast_per_ray3(pln_o, x),
                              bcast_per_ray3(pln_d, x), ds,
                              E.max_steps_fwd(max(rif.shape), h, ds))


def trace_target_ad(rif: torch.Tensor, x: torch.Tensor, v: torch.Tensor, target: torch.Tensor,
                    h: float, ds: float):
    """Tape twin of :func:`trace_target` (``eikonal.trace_target_scan``, its steps
    gated on ``~all(esc)``); no kernel."""
    _check_rif(rif, "trace_target_ad")
    _check_rays(x, v, "trace_target_ad")
    h, ds = float(h), float(ds)
    return E.trace_target_scan(G.GridField(rif, h), x, v, bcast_per_ray3(target, x), ds,
                               E.max_steps_fwd(max(rif.shape), h, ds))


def trace_sdf_ad(rif: torch.Tensor, sdf: torch.Tensor, x: torch.Tensor, v: torch.Tensor,
                 h: float, ds: float):
    """Tape twin of :func:`trace_sdf` (``eikonal.trace_sdf_scan``); no kernel."""
    _check_rif(rif, "trace_sdf_ad")
    _check_rays(x, v, "trace_sdf_ad")
    h, ds = float(h), float(ds)
    return E.trace_sdf_scan(G.GridField(rif, h), G.GridField(sdf, h), x, v, ds,
                            sdf_steps(rif.shape, h, ds))


def _check_cable(rif, x, v, target, name):
    if rif.ndim != 1:
        raise ValueError(f"{name}: rif must be a 1D radial profile, got {tuple(rif.shape)}")
    _check_rays(x, v, name)
    _check_per_ray3(target, x, "target", name)


def cable_steps(length: float, ds: float) -> int:
    """The cable step bound, ``int(4 * length / ds)`` in Python floats."""
    return int(4.0 * float(length) / float(ds))


class _TraceCable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rif, x, v, target, radius, length, ds):
        rif, x, v = (t.detach().contiguous() for t in (rif, x, v))
        tgt = bcast_per_ray3(target.detach(), x)
        steps = cable_steps(length, ds)
        if rif.is_cuda:
            xt, vt, d2 = K.trace_cable(rif, radius, length, x, v, tgt, ds, steps)
        else:
            xt, vt, d2 = E.trace_cable(C.CylinderField(rif, radius, length), x, v, tgt, ds,
                                       steps)
        ctx.save_for_backward(rif, xt, vt)
        ctx.radius, ctx.length, ctx.ds = radius, length, ds
        return xt, vt, d2

    @staticmethod
    def backward(ctx, dxt, dvt, dd2):
        # the cotangent of dist2 is dropped, as the JAX rule drops it
        rif, xt, vt = ctx.saved_tensors
        radius, length, ds = ctx.radius, ctx.length, ctx.ds
        steps = cable_steps(length, ds)
        dxt, dvt = dxt.contiguous(), dvt.contiguous()
        if rif.is_cuda:
            g = K.backtrace_cable(rif, radius, length, xt, vt, dxt, dvt, ds, steps,
                                  G.snap_tol(rif.dtype) * radius).to(rif.dtype)
        else:
            g = E.backtrace_cable(C.CylinderField(rif, radius, length), xt, vt, dxt, dvt, ds,
                                  steps)
        return g, None, None, None, None, None, None


def trace_cable(rif: torch.Tensor, radius: float, length: float, x: torch.Tensor,
                v: torch.Tensor, target: torch.Tensor, ds: float):
    """Cylinder-volume trace toward ``target``; ``rif`` is the 1D radial profile.

    Returns the closest approach ``(xt, vt, dist2)``.  d(loss)/d(rif) is the
    constant-memory adjoint (K8 on the card); ``x``, ``v`` and ``target``
    receive no gradient and the cotangent of ``dist2`` is dropped.
    ``target`` is (N, 3), or (3,) / (1, 3) for every ray.  The step bound is
    ``int(4 * length / ds)``.
    """
    _check_cable(rif, x, v, target, "trace_cable")
    return _TraceCable.apply(rif, x, v, target, float(radius), float(length), float(ds))


def trace_cable_ad(rif: torch.Tensor, radius: float, length: float, x: torch.Tensor,
                   v: torch.Tensor, target: torch.Tensor, ds: float):
    """Tape twin of :func:`trace_cable`: autograd through the fixed-trip plain
    stepper (``eikonal.trace_cable_scan``), where its tensors live.  It
    launches no kernel; every input, ``dist2`` included, carries its gradient."""
    _check_cable(rif, x, v, target, "trace_cable_ad")
    return E.trace_cable_scan(C.CylinderField(rif, float(radius), float(length)), x, v,
                              bcast_per_ray3(target, x), float(ds), cable_steps(length, ds))
