"""One wrapper per CUDA kernel: argument checks, output allocation, launch on
the current stream, launch-error check, and a launch counter.

The wrappers take CUDA tensors only and raise on anything else; the callers
that users reach (``fields.grid.eval_grad``, ``tracer.api.trace``) send CPU
tensors to the plain versions instead (``fields.grid.eval_grad_plain``,
``tracer.eikonal.trace`` / ``backtrace``).

K1 ``eval_grad`` (csrc/eval_grad.cu)
    replaces ``benchmarks/probe_evalmath.py::_pl_eval_kernel`` of the JAX
    package (fused n, grad n evaluation); bound by bytes (28 B per point plus
    the grid once); one thread per point, corners read from the raw grid
    through L1/L2, no window table to build or gather.
K2 ``trace_fwd`` (csrc/trace_fwd.cu)
    replaces the forward stepper loop ``tracer/paired.py::trace``; bound by
    operations (58 flops per ray-step at the least, grid resident in L2); the whole step
    loop runs inside one launch with the ray state in registers and a per-ray
    early exit.
K3 ``backtrace`` (csrc/backtrace.cu)
    replaces the adjoint sweep loop ``tracer/paired.py::backtrace``; bound by
    operations and by 8 atomicAdds per active ray-step; one thread per ray,
    the only device-memory traffic in the loop is the atomics.  Their order is
    not fixed, so the gradient is not bitwise reproducible from run to run
    (the CPU path's ``index_add_`` is).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

#: launches per kernel since the last :func:`reset_launches`; a wrapper adds
#: one where it launches its kernel and nowhere else
LAUNCHES = {name: 0 for name in build.KERNELS}

_VP, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = {
    "eval_grad": [_I, _VP, _I, _I, _I, _D, _VP, _VP, _VP, _VP, _I, _VP],
    "trace_fwd": [_I, _VP, _I, _I, _I, _D, _D, _VP, _VP, _VP, _VP, _I, _I, _VP],
    "backtrace": [_I, _VP, _I, _I, _I, _D, _D, _D, _VP, _VP, _VP, _VP, _VP, _I, _I, _VP],
}
_INT_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_grid(data: torch.Tensor, name: str) -> None:
    if not data.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got a grid on {data.device}")
    if data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: grid must be float32 or float64, got {data.dtype}")
    if data.ndim != 3 or not data.is_contiguous():
        raise ValueError(f"{name}: grid must be a contiguous (D, H, W) tensor, "
                         f"got shape {tuple(data.shape)}, strides {data.stride()}")
    if data.numel() == 0 or data.numel() > _INT_MAX:
        raise ValueError(f"{name}: grid of {data.numel()} voxels is outside the "
                         "kernel's int32 indexing")


def _check_rays(data: torch.Tensor, name: str, **arrays: torch.Tensor) -> int:
    n = next(iter(arrays.values())).shape[0] if arrays else 0
    for label, a in arrays.items():
        if a.device != data.device or a.dtype != data.dtype:
            raise ValueError(f"{name}: {label} is {a.dtype} on {a.device}, the grid is "
                             f"{data.dtype} on {data.device}")
        if a.ndim != 2 or a.shape != (n, 3) or not a.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous ({n}, 3) tensor, "
                             f"got shape {tuple(a.shape)}, strides {a.stride()}")
    if 3 * n > _INT_MAX:
        raise ValueError(f"{name}: {n} rays are outside the kernel's int32 indexing")
    return n


def _launch(name: str, data: torch.Tensor, *args) -> None:
    """Call kernel ``name`` on ``data``'s device and current stream; raise if refused."""
    fn = getattr(build.load(name), f"anrt_{name}")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = _I
    d, hgt, wid = data.shape
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(int(data.dtype == torch.float64), data.data_ptr(), wid, hgt, d, *args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


def eval_grad(data: torch.Tensor, h: float, p: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: ``(n (N,), grad (N, 3))`` of the grid ``data[z, y, x]`` at ``p`` (N, 3)."""
    _check_grid(data, "eval_grad")
    n_pts = _check_rays(data, "eval_grad", p=p)
    if mask is not None and (mask.device != data.device or mask.dtype != torch.bool
                             or mask.shape != (n_pts,) or not mask.is_contiguous()):
        raise ValueError(f"eval_grad: mask must be a contiguous bool ({n_pts},) tensor on "
                         f"{data.device}, got {mask.dtype} {tuple(mask.shape)} on {mask.device}")
    n = torch.empty((n_pts,), dtype=data.dtype, device=data.device)
    grad = torch.empty((n_pts, 3), dtype=data.dtype, device=data.device)
    if n_pts:  # nothing to launch for an empty batch
        _launch("eval_grad", data, float(h), p.data_ptr(),
                None if mask is None else mask.data_ptr(), n.data_ptr(), grad.data_ptr(),
                n_pts)
    return n, grad


def trace_fwd(data: torch.Tensor, h: float, x0: torch.Tensor, v0: torch.Tensor,
              ds: float, max_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: exit state ``(xt, vt)`` of the rays ``(x0, v0)`` after at most ``max_steps``."""
    _check_grid(data, "trace_fwd")
    n_rays = _check_rays(data, "trace_fwd", x0=x0, v0=v0)
    xt = torch.empty_like(x0)
    vt = torch.empty_like(v0)
    if n_rays:
        _launch("trace_fwd", data, float(h), float(ds), x0.data_ptr(), v0.data_ptr(),
                xt.data_ptr(), vt.data_ptr(), n_rays, int(max_steps))
    return xt, vt


def backtrace(data: torch.Tensor, h: float, xt: torch.Tensor, vt: torch.Tensor,
              dx: torch.Tensor, dv: torch.Tensor, ds: float, max_steps: int,
              snap_tol: float) -> torch.Tensor:
    """K3: flat ``(D*H*W,)`` voxel gradient from exit state and cotangents."""
    _check_grid(data, "backtrace")
    n_rays = _check_rays(data, "backtrace", xt=xt, vt=vt, dx=dx, dv=dv)
    g = torch.zeros((data.numel(),), dtype=data.dtype, device=data.device)
    if n_rays:
        _launch("backtrace", data, float(h), float(ds), float(snap_tol), xt.data_ptr(),
                vt.data_ptr(), dx.data_ptr(), dv.data_ptr(), g.data_ptr(), n_rays,
                int(max_steps))
    return g
