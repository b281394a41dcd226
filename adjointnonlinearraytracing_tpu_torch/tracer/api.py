"""Differentiable tracing API: ``trace`` and ``trace_cable`` as
``torch.autograd.Function`` classes whose backward pass is the constant-memory
adjoint sweep, and their taped twins ``trace_ad`` and ``trace_cable_ad``.

Twin of ``adjointnonlinearraytracing_tpu/tracer/api.py::trace``,
``trace_cable``, ``trace_ad`` and ``trace_cable_ad`` (the plane, target and
sdf variants wait for ``ROADMAP.md`` A5).

Gradient contract: only the field data ``rif`` receives a gradient; the ray
inputs ``x``, ``v`` get none.  ``h`` and ``ds`` are Python floats.

Where it runs: CUDA tensors go through the hand-written kernels
(``kernels/csrc/trace_fwd.cu``, ``kernels/csrc/backtrace.cu``; for the cable,
``trace_cable.cu`` and ``backtrace_cable.cu``) or raise; CPU tensors go
through the plain steppers of ``tracer/eikonal.py``.  There is no
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


class _Trace(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rif, x, v, h, ds):
        # the kernels take contiguous tensors; the CPU path takes any strides,
        # and the same call must work on both
        rif, x, v = (t.detach().contiguous() for t in (rif, x, v))
        steps = E.max_steps_fwd(max(rif.shape), h, ds)
        order = None
        if rif.is_cuda:
            order = O.ray_order(x, v, rif.shape, h)
            xt, vt = K.trace_fwd(rif, h, x, v, ds, steps, order)
        else:
            xt, vt = E.trace(G.GridField(rif, h), x, v, ds, steps)
        ctx.save_for_backward(rif, xt, vt, order)
        ctx.h, ctx.ds = h, ds
        return xt, vt

    @staticmethod
    def backward(ctx, dxt, dvt):
        rif, xt, vt, order = ctx.saved_tensors
        h, ds = ctx.h, ctx.ds
        steps = E.max_steps_bwd(max(rif.shape), h, ds)
        if rif.is_cuda:
            g = K.backtrace(rif, h, xt, vt, dxt.contiguous(), dvt.contiguous(), ds, steps,
                            G.snap_tol(rif.dtype), order)
        else:
            g = E.backtrace(G.GridField(rif, h), xt, vt, dxt, dvt, ds, steps)
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
