"""Reference-style API: the reference's class names over the port's functions.

Twin of ``adjointnonlinearraytracing_tpu/compat.py``.  Users coming from the
reference torch code (``core/grid.py``'s ``Grid``, ``core/cable.py``'s
``Cable``, ``core/tracer.py``'s ``*TracerC.apply``) call these: the tracer
aliases are the functions of ``tracer/api.py`` (call them as the reference
calls ``.apply``), and ``Grid`` / ``Cable`` are thin objects over
``fields/rbf.py`` and ``fields/cylinder.py`` whose splats replace the held
grid and return ``self``, as the reference's mutate it.

=====================  ==========================================
reference              this package
=====================  ==========================================
BackTracerC.apply      tracer.trace            (adjoint gradient)
ADTracerC.apply        tracer.trace_ad         (autodiff gradient)
BackPlaneTracerC       tracer.trace_plane
BackTargetTracerC      tracer.trace_target
BackSDFTracerC         tracer.trace_sdf
BackCableTracerC       tracer.trace_cable
=====================  ==========================================

The tracers run where their tensors live: on the card through the kernels
(K2/K3, K11-K14, K7/K8), on the CPU through the plain steppers.  ``Grid``,
``Cable`` and ``upres_volume`` keep a torch tensor where it lies and put
anything else (a numpy array, a list) on ``device``, the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import torch

from .convert import require_device
from .fields import cylinder as C
from .fields import grid as G
from .fields import rbf
from .tracer import (trace, trace_ad, trace_cable, trace_cable_ad,  # noqa: F401
                     trace_plane, trace_plane_ad, trace_sdf, trace_sdf_ad, trace_target)

# reference-class-name aliases (apply-style call signatures)
ADTracerC = trace_ad
ADPlaneTracerC = trace_plane_ad
ADSDFTracerC = trace_sdf_ad
ADCableTracerC = trace_cable_ad
BackTracerC = trace
BackPlaneTracerC = trace_plane
BackTargetTracerC = trace_target
BackSDFTracerC = trace_sdf
BackCableTracerC = trace_cable


def _as_field_tensor(arr, device):
    """A torch tensor as it is; anything else as a tensor on ``device``."""
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.as_tensor(arr, device=require_device(device))


def upres_volume(n, new_res, *, device="cuda"):
    """``fields.grid.upres_volume`` of ``n``: a torch tensor where it lies, anything
    else (a numpy volume, a list) on ``device``, the card unless the caller
    asks for the CPU (the JAX function takes a numpy volume as it is)."""
    return G.upres_volume(_as_field_tensor(n, device), new_res)


class Grid:
    """Object wrapper over ``fields.rbf`` (reference ``core/grid.py`` ``Grid``)."""

    def __init__(self, scene, h, hinv=None, *, device="cuda"):
        scene = _as_field_tensor(scene, device)
        self._g = rbf.RbfGrid(scene, torch.zeros_like(scene), h)
        self.h = h
        self.hinv = hinv

    @property
    def scene(self):
        return self._g.scene

    @property
    def weights(self):
        return self._g.weights

    @property
    def res(self):
        return tuple(self._g.scene.shape)

    def render(self):
        return self._g.render()

    def RenderGradient(self, linear=False):
        return rbf.render_gradient(self._g, linear=linear)

    def Get(self, x, sigmoid=False, cubic=False):
        return rbf.get(self._g, x, sigmoid=sigmoid, cubic=cubic)

    def GetLinear(self, x):
        return rbf.get_linear(self._g, x)

    def GetSpline(self, x):
        return rbf.get_spline(self._g, x)

    def GetHessian(self, x):
        return rbf.get_hessian(self._g, x)

    def Splat(self, x, f, average=True, mask=None):
        self._g = rbf.splat(self._g, x, f, average=average, mask=mask)
        return self

    def SplatGrad(self, x, f, fx):
        self._g = rbf.splat_grad(self._g, x, f, fx)
        return self

    def SplatLinear(self, x, f, fx, mask=None):
        self._g = rbf.splat_linear(self._g, x, f, fx, mask=mask)
        return self

    def SolveGrad(self, x, f, fx):
        self._g = rbf.solve_grad(self._g, x, f, fx)
        return self


class Cable:
    """Object wrapper over ``fields.cylinder`` (reference ``core/cable.py``)."""

    def __init__(self, rif, radius, length=None, *, device="cuda"):
        if length is None:
            length = radius
        self._f = C.CylinderField(_as_field_tensor(rif, device), radius, length)

    @property
    def rif(self):
        return self._f.data

    @property
    def radius(self):
        return self._f.radius

    @property
    def length(self):
        return self._f.length

    @property
    def h(self):
        return self._f.h

    def GetLinear(self, x):
        return C.cyl_eval_grad(self._f, x)

    def render(self, res):
        return C.cyl_render(self._f, res)

    def render2(self, res):
        return C.cyl_render2(self._f, res)

    def RenderGradient(self):
        """The profile's gradient at its bins, along +x from the axis at y = 0."""
        data = self._f.data
        r = self._f.h * torch.arange(data.shape[0], dtype=data.dtype, device=data.device)
        pos = torch.stack([self._f.radius + r, torch.zeros_like(r),
                           torch.full_like(r, self._f.radius)], dim=-1)
        return C.cyl_eval_grad(self._f, pos)[1]
