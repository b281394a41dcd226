"""One wrapper per CUDA kernel: argument checks, output allocation, launch on
the current stream, launch-error check, and a launch counter.

The wrappers take CUDA tensors only and raise on anything else; the callers
that users reach (``fields.grid.eval_grad``, ``tracer.api.trace``,
``benchmarks.probe_dma_gather.gather_rows``) send CPU tensors to the plain
versions instead (``fields.grid.eval_grad_plain``, ``tracer.eikonal.trace`` /
``backtrace``, ``benchmarks.probe_dma_gather.gather_rows_plain``).

K1 ``eval_grad`` (csrc/eval_grad.cu)
    replaces ``benchmarks/probe_evalmath.py::_pl_eval_kernel`` of the JAX
    package (fused n, grad n evaluation); bound by bytes (29 B per point plus
    the grid once), held back in fact by the corner gathers; one thread a
    point, each x-pair of corners in one 16-byte load where it lies in one;
    corners read from the raw grid through L1/L2, no window table to build or
    gather.
K2 ``trace_fwd`` (csrc/trace_fwd.cu)
    replaces the forward stepper loop ``tracer/paired.py::trace``; bound by
    operations (58 flops per ray-step at the least, grid resident in L2); the whole step
    loop runs inside one launch with the ray state in registers and a per-ray
    early exit.  What holds it back is how many distinct lines a warp's
    corner reads touch, so it takes an optional ray ``order``
    (``tracer/order.py``): thread ``i`` runs ray ``order[i]``, outputs stay in
    the caller's order and are the same bit for bit.
K3 ``backtrace`` (csrc/backtrace.cu)
    replaces the adjoint sweep loop ``tracer/paired.py::backtrace``; bound by
    operations and by the atomic adds of the splat, which serialise on one
    address (every fuel stage splats ~2.5e8 terms, onto 27 words at 3^3).  A
    ray sums its splats into one cell in registers and adds them when it
    leaves the cell (one add a corner per run: ``flushes`` in the plain
    version's stats), lanes of a warp leaving the same cell at once sum
    their runs with shuffles and add once; where the gradient fits shared memory
    (:func:`backtrace_path`: ``D*H*W`` elements within
    :data:`SHARED_BYTES_MAX`) persistent blocks add runs into a
    block-private gradient and that to device memory once, else runs go to
    device memory; the same optional ray ``order`` as K2.  The adds' order is
    not fixed, so the gradient is not bitwise reproducible from run to run
    (the CPU path's ``index_add_`` is).
K4 ``gather_rows`` (csrc/gather_rows.cu)
    replaces the semaphore-ring row gather
    ``benchmarks/probe_dma_gather.py::_ring_kernel``; bound by bytes (each
    row read once and written once, plus the index); one warp per row, 16
    bytes per lane, bit-exact.
K5 ``trace_ckpt`` (csrc/trace_fwd.cu, K2's loop compiled with checkpoints)
    the forward pass of the exact gradient, replacing the segmented XLA
    forward ``tracer/checkpointed.py::_forward_with_ckpts``: K2's stepper,
    which also writes each ray's state ``(x, v, inside)`` every ``seg`` steps
    (until it escapes), its capture step ``c`` and how it ended; the
    checkpoints are one field of all the rays to a row.  The exit state is
    K2's, bit for bit.
K6 ``backtrace_exact`` (csrc/backtrace_exact.cu)
    the backward pass of the exact gradient, replacing
    ``tracer/checkpointed.py::_backward_segments``: per ray, the segments
    below its capture step from last to first, each replayed forward from
    its checkpoint with K2's step, then the adjoint update and splat of K3
    in reverse over the replayed positions; the lanes of a warp walk the
    segments and steps in step, so neighbouring rays of the order stay at
    neighbouring positions; K3's run sums and warp sums, on the global path
    at every grid size (an H100 ran K6's first design 1.6-1.7 times slower
    on the shared path, at every fuel stage where K3 takes it).

The variants of K2 and K3 (``csrc/trace_fwd.cu``, ``csrc/backtrace.cu``):
K2's loop under another stop and capture rule, and K3's ray with another
"active" rule; the same ray ``order`` and, for K14, K3's paths.

K11 ``trace_plane``
    replaces ``tracer/paired.py::trace_plane``: a ray also stops past its
    plane; ``(xt, vt)`` as K2's and ``miss`` (never escaped).
K12 ``trace_target``
    replaces ``tracer/paired.py::trace_target``: the closest approach to a
    target per ray.  An escaped ray goes on (straight) until the batch's last
    ray escapes, so a call is two launches: pass 1 steps each ray to its
    escape and keeps that step's maximum on the card, pass 2 steps the
    escaped rays on to it, each only until it can come no closer
    (:func:`target_retired_plain`); both counted in :data:`LAUNCHES`.
K13 ``trace_sdf``
    replaces ``tracer/paired.py::trace_sdf``: "inside" is ``sdf < 0`` on a
    second grid; the same two passes as K12, pass 2 stepping only the rays
    that escaped the grid while still inside the sdf.  A step takes one
    stencil for both grids and loads the sdf's corners and the next step's
    grid corners together (``csrc/rules.cuh``, ``sdf_step``).
K14 ``backtrace_sdf``
    replaces ``tracer/paired.py::backtrace_sdf``: K3 with the sdf-crossing
    deactivation, one stencil a step for both grids, its adds in float64
    whatever the grid's type (the wrapper returns the float64 sum; callers
    cast) after run and warp sums in the grid's type; K3's paths by the
    float64 size rule (:func:`backtrace_path`), counted in
    :data:`BACKTRACE_SDF_PATHS`.

The variants' exact gradients (``tracer/checkpointed.py``'s
``trace_plane_exact``, ``trace_target_exact``, ``trace_sdf_exact``): K11-K13
compiled with K5's checkpoints, and K6's replaying ray under the plane's and
the sdf's rule (``csrc/rules.cuh``); the target's backward pass is K6.

K15 ``trace_plane_ckpt``
    replaces ``tracer/checkpointed.py::_forward_with_ckpts`` (plane): K11's
    one pass, writing K5's checkpoints, capture step and code.
K16 ``trace_target_ckpt``
    the same (target): K12's two passes, pass 2 writing the checkpoints of
    the steps an escaped ray takes on to the batch's horizon, up to where
    K12's stops it (its rows after that are rows the backward pass never
    reads).
K17 ``trace_sdf_ckpt``
    the same (sdf): K13's two passes, pass 2 stepping each ray that is still
    inside the sdf on to its own horizon (given, or its JAX chunk's: pass 1
    takes each chunk's last escape step, pass 2 rounds it up to a segment
    boundary, :func:`sdf_chunk_horizons_plain`), writing checkpoints.
K18 ``backtrace_plane_exact``
    replaces ``tracer/checkpointed.py::_backward_segments`` (plane): K6's
    ray whose replay applies the plane's rule; the leader of a run's warp
    sum adds its 8 sums as 4 x-pairs of corners, each pair that lies in one
    aligned group of 4 words as one float4 add.
K19 ``backtrace_sdf_exact``
    the same (sdf): K6's ray whose replay reads the sdf with the stencil of
    the next evaluation; its run and warp sums in the grid's type, its adds
    in float64 whatever the grid's type, as K14 sums (``out`` is float64;
    callers cast).

K20 ``record_paths`` (csrc/trace_fwd.cu)
    replaces the recording scan of ``pathmatrix/fuel2008.py::record_paths``
    (the 2008 baseline's "true" path model): K2's step with no stop for a
    fixed ``(nrec - 1) * stride`` steps, each ray's position written as
    float32 every ``stride`` steps in the path matrix's flat layout; bound by
    its steps' operations (the records are 12 bytes a ray each).

The cable kernels trace a radial profile (``fields/cylinder.py``) toward a
target point per ray; their field code is ``csrc/cylinder.cuh``, one stepper
for K7, K9 and K10's replay.  They take no ray order, and the adjoints sum the
gradient in float64 whatever the profile's type (the wrappers return it so;
callers cast).  A kernel takes its longest ray's steps times the latency of
one step (each ray's steps are a chain of dependent operations, and a few
thousand rays leave at most one warp a scheduler), so the design shortens a
step (``tools/cable_designs.py`` measures each part): each block builds a per-bin table of
the profile in shared memory (values and radial derivative), and f32
divisions and square roots take the IEEE fast paths without the compiler's
slow-path branch around each one (``div_rn``, ``sqrt_rn``).

K7 ``trace_cable`` (csrc/trace_cable.cu)
    replaces the cable stepper loop ``tracer/eikonal.py::trace_cable``; one
    thread a ray, the whole loop in the kernel, a ray leaving it when it
    freezes; closest approach ``(xt, vt, d2)`` bit for bit the plain
    version's.
K8 ``backtrace_cable`` (csrc/backtrace_cable.cu)
    replaces the cable adjoint sweep ``tracer/eikonal.py::backtrace_cable``;
    each lane adds its splats to its own column of its block's gradient in
    shared memory (no atomics), each block adds its gradient to device memory
    once; a profile too large for the columns (:func:`backtrace_cable_path`)
    takes one gradient a block, to which a ray adds its splats per pair of
    bins summed in registers.
K9 ``trace_cable_ckpt`` (csrc/trace_cable.cu, K7's step with checkpoints)
    the exact cable gradient's forward pass, replacing
    ``tracer/checkpointed.py::_fwd_ckpts_cable``: also writes ``(x, v, esc)``
    at each segment start before the ray freezes (a loop over segments around
    one over a segment's steps, the store between them) and the capture step
    ``c``.
K10 ``backtrace_cable_exact`` (csrc/backtrace_cable_exact.cu)
    the exact cable gradient's backward pass, replacing
    ``tracer/checkpointed.py::_bwd_segments_cable``: per ray the segments below
    its capture step, last to first, each replayed with K7's step, then K8's
    adjoint update in reverse gated by ``k < c``; a block's replay warp
    replays the next stretch into one of two buffers while its adjoint warp
    sweeps the other, for the same 32 rays; splats to a lane's column as K8's,
    the buffers in shared memory beside the columns, or, where they do not fit
    (:func:`backtrace_cable_exact_path`), runs into one gradient a block, the
    buffers in device memory, so that K10 takes every profile K8 takes.

The z-slab ring (``parallel/slabs.py``): the grid split along z over the
ranks, one slab a rank, the slabs passed one hop round the ring a phase; a
ray steps only while its cell row lies in the slab at hand.  Both kernels
read the slab as a z-window of the grid (voxel rows ``[z_first, z_first +
rows)``, ``csrc/trilinear.cuh``) with the unsharded kernels' steps, keep each
ray's state in device memory between phases, and set a word when a ray has
steps left.  The ring launches each phase as a sweep of z-bands that L2 holds
(``parallel/slabs.py::sweep_bands``, :func:`slab_trace_bands`,
:func:`slab_backtrace_bands`): a launch steps the rays whose cell row lies in
one of two bands of the slab, the phase's cap counted from the step counts at
its start, a per-thread gate letting the other rays' threads leave at once.

K21 ``slab_trace_phase`` (csrc/slab.cu)
    replaces the inner loop of ``parallel/slabs.py::_fwd_local`` (up to ``K``
    forward steps a ray a phase): K2's step under K2's or K11's rule, capped
    at K2's ``max_steps`` by a per-ray step count, so the state after any
    phase is K2's bit for bit.
K22 ``slab_backtrace_phase`` (csrc/slab.cu)
    replaces the inner loop of ``parallel/slabs.py::_bwd_local``: K3's ray on
    the window, its run and warp sums added into the window's gradient,
    every run flushed before the launch ends.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, List, Optional, Tuple, Union

import torch

from . import build

#: launches per kernel since the last :func:`reset_launches`; a wrapper adds
#: one where it launches its kernel and nowhere else
LAUNCHES = {name: 0 for name in build.KERNELS}
#: K3's launches by path (:func:`backtrace_path`), counted with ``LAUNCHES``
BACKTRACE_PATHS = {"shared": 0, "global": 0}
#: K14's launches by path (:func:`backtrace_path` of its float64 gradient), counted
#: with ``LAUNCHES``
BACKTRACE_SDF_PATHS = {"shared": 0, "global": 0}
#: K8's launches by path (:func:`backtrace_cable_path`), counted with ``LAUNCHES``
BACKTRACE_CABLE_PATHS = {"columns": 0, "block": 0}
#: K10's launches by path (:func:`backtrace_cable_exact_path`), counted with ``LAUNCHES``
BACKTRACE_CABLE_EXACT_PATHS = {"columns": 0, "block": 0}
#: the dynamic shared memory one block may opt in to on sm_90 (227 KB);
#: ``kSharedMax`` in csrc/backtrace.cu
SHARED_BYTES_MAX = 232448

_VP, _I, _D, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
_ARGTYPES = {
    "eval_grad": [_I, _VP, _I, _I, _I, _D, _VP, _VP, _VP, _VP, _I, _I, _VP],
    "trace_fwd": [_I, _VP, _I, _I, _I, _D, _D, _VP, _VP, _VP, _VP, _VP, _I, _I, _VP],
    "backtrace": [_I, _VP, _I, _I, _I, _D, _D, _D, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I,
                  _I, _VP],
    "gather_rows": [_I, _VP, _VP, _VP, _LL, _I, _VP],
    "trace_ckpt": [_I, _VP, _I, _I, _I, _D, _D, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I,
                   _I, _I, _VP],
    "backtrace_exact": [_I, _VP, _I, _I, _I, _D, _D, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                        _I, _I, _I, _VP],
    "trace_cable": [_I, _VP, _I, _D, _D, _D, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _VP],
    "backtrace_cable": [_I, _VP, _I, _D, _D, _D, _D, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    "trace_cable_ckpt": [_I, _VP, _I, _D, _D, _D, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I,
                         _I, _I, _VP],
    "backtrace_cable_exact": [_I, _VP, _I, _D, _D, _D, _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                              _I, _VP, _I, _VP],
    "trace_plane": [_I, _VP, _I, _I, _I, _D, _D, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I,
                    _VP],
    "trace_target": [_I, _VP, _I, _I, _I, _D, _D, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                     _VP, _VP, _VP, _I, _I, _I, _VP],
    "trace_sdf": [_I, _VP, _I, _I, _I, _D, _D, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                  _VP, _I, _I, _I, _VP],
    "backtrace_sdf": [_I, _VP, _I, _I, _I, _D, _D, _D, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                      _I, _I, _I, _VP],
    "trace_plane_ckpt": [_I, _VP, _I, _I, _I, _D, _D] + [_VP] * 11 + [_I, _I, _I, _VP],
    "trace_target_ckpt": [_I, _VP, _I, _I, _I, _D, _D] + [_VP] * 15 + [_I, _I, _I, _I, _VP],
    "trace_sdf_ckpt": [_I, _VP, _I, _I, _I, _D, _D] + [_VP] * 16 + [_I] * 5 + [_VP],
    "backtrace_plane_exact": [_I, _VP, _I, _I, _I, _D, _D] + [_VP] * 10 + [_I, _I, _I, _VP],
    "backtrace_sdf_exact": [_I, _VP, _I, _I, _I, _D, _D] + [_VP] * 9 + [_I, _I, _I, _VP],
    "record_paths": [_I, _VP, _I, _I, _I, _D, _D, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    "slab_trace_phase": [_I, _VP, _I, _I, _I, _D, _D, _I, _I] + [_VP] * 13 + [_I] * 8 + [_VP],
    "slab_backtrace_phase": [_I, _VP, _I, _I, _I, _D, _D, _D, _I, _I] + [_VP] * 11 + [_I] * 8
                            + [_VP],
}
#: the states a checkpoint holds: x, v, inside (the cable kernels: x, v, esc)
CKPT_WIDTH = 7
_VEC_BYTES = 16  # K4 moves 128-bit vectors
_INT_MAX = 2 ** 31 - 1


#: when a list, every launch appends ``(kernel name, start event, stop event)``
#: to it: CUDA events recorded on the launch's stream around the kernel, read
#: by the caller after a synchronise (see :func:`record_events`)
_events: Optional[List[Tuple[str, "torch.cuda.Event", "torch.cuda.Event"]]] = None


def reset_launches() -> None:
    for counts in (LAUNCHES, BACKTRACE_PATHS, BACKTRACE_SDF_PATHS, BACKTRACE_CABLE_PATHS,
                   BACKTRACE_CABLE_EXACT_PATHS):
        for name in counts:
            counts[name] = 0


def record_events(sink: Optional[list]) -> None:
    """Time every launch from now on into ``sink`` (a list), or stop with ``None``.

    Lets a run say how much of a training step its kernels take without a
    profiler: two event records per launch, no synchronisation.
    """
    global _events
    _events = sink


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


_FNS: dict = {}


def _kernel(name: str):
    """Kernel ``name``'s C entry point, its argument types set (built at first use)."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load(name), f"anrt_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        _FNS[name] = fn
    return fn


def _run(name: str, fn, stream: "torch.cuda.Stream", args) -> None:
    """Call ``fn`` (kernel ``name``) with ``args`` on ``stream``; raise if refused.

    The one place a launch is counted.
    """
    sink = _events
    if sink is not None:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record(stream)
    err = fn(*args, stream.cuda_stream)
    if sink is not None:
        stop.record(stream)
        sink.append((name, start, stop))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


def _launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name`` with ``args`` and ``device``'s current stream; raise if refused."""
    fn = _kernel(name)
    with torch.cuda.device(device):
        _run(name, fn, torch.cuda.current_stream(), args)


def _check_order(order: Optional[torch.Tensor], data: torch.Tensor, n: int, name: str) -> None:
    if order is not None and (order.device != data.device or order.dtype != torch.int32
                              or order.shape != (n,) or not order.is_contiguous()):
        raise ValueError(f"{name}: order must be a contiguous int32 ({n},) tensor on "
                         f"{data.device}, got {order.dtype} {tuple(order.shape)} on {order.device}")


#: the counters of an exact backward pass's ``tally`` (K6, K18, K19;
#: ``ExactTally`` in csrc/backtrace_exact.cu): runs flushed, flushes issued
#: after the warp sums, atomic adds into device memory, and those of them that
#: were float4 adds (K18's x-pairs of a run's corners; K6 adds each run's 8
#: sums one by one, K19 its f64 sums).
EXACT_TALLY = ("runs", "issued", "adds", "float4_adds")


def _check_tally(tally: Optional[torch.Tensor], data: torch.Tensor, name: str,
                 size: int = 3) -> None:
    if tally is not None and (tally.device != data.device or tally.dtype != torch.int64
                              or tally.shape != (size,) or not tally.is_contiguous()):
        raise ValueError(f"{name}: tally must be a contiguous int64 ({size},) tensor on "
                         f"{data.device}, got {tally.dtype} {tuple(tally.shape)} on {tally.device}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch_on_grid(name: str, data: torch.Tensor, *args) -> None:
    """:func:`_launch` for the kernels whose first arguments are a ``(D, H, W)`` grid."""
    d, hgt, wid = data.shape
    _launch(name, data.device, int(data.dtype == torch.float64), data.data_ptr(),
            wid, hgt, d, *args)


def eval_grad(data: torch.Tensor, h: float, p: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              pair_loads: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: ``(n (N,), grad (N, 3))`` of the grid ``data[z, y, x]`` at ``p`` (N, 3).

    ``pair_loads=False`` runs the first design (the 8 corners one by one),
    kept as a yardstick; the result is the same bit for bit.
    """
    _check_grid(data, "eval_grad")
    n_pts = _check_rays(data, "eval_grad", p=p)
    if mask is not None and (mask.device != data.device or mask.dtype != torch.bool
                             or mask.shape != (n_pts,) or not mask.is_contiguous()):
        raise ValueError(f"eval_grad: mask must be a contiguous bool ({n_pts},) tensor on "
                         f"{data.device}, got {mask.dtype} {tuple(mask.shape)} on {mask.device}")
    n = torch.empty((n_pts,), dtype=data.dtype, device=data.device)
    grad = torch.empty((n_pts, 3), dtype=data.dtype, device=data.device)
    if n_pts:  # nothing to launch for an empty batch
        _launch_on_grid("eval_grad", data, float(h), p.data_ptr(),
                        None if mask is None else mask.data_ptr(), n.data_ptr(),
                        grad.data_ptr(), n_pts, int(pair_loads))
    return n, grad


def trace_fwd(data: torch.Tensor, h: float, x0: torch.Tensor, v0: torch.Tensor,
              ds: float, max_steps: int, order: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: exit state ``(xt, vt)`` of the rays ``(x0, v0)`` after at most ``max_steps``.

    ``order`` (int32 ``(N,)``, a permutation) is the order the threads take
    the rays in; the outputs are in the rays' own order either way.
    """
    _check_grid(data, "trace_fwd")
    n_rays = _check_rays(data, "trace_fwd", x0=x0, v0=v0)
    _check_order(order, data, n_rays, "trace_fwd")
    xt = torch.empty_like(x0)
    vt = torch.empty_like(v0)
    if n_rays:
        _launch_on_grid("trace_fwd", data, float(h), float(ds), x0.data_ptr(), v0.data_ptr(),
                        _ptr(order), xt.data_ptr(), vt.data_ptr(), n_rays, int(max_steps))
    return xt, vt


def record_paths(data: torch.Tensor, h: float, x0: torch.Tensor, v0: torch.Tensor,
                 ds: float, nrec: int, stride: int,
                 order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K20: the float32 ``(nrec * N, 3)`` trajectories of the rays ``(x0, v0)``:
    row ``k * N + i`` is ray ``i`` after ``k * stride`` steps of K2's step with
    no stop (record 0 is ``x0``).  ``order`` as for :func:`trace_fwd`."""
    _check_grid(data, "record_paths")
    n_rays = _check_rays(data, "record_paths", x0=x0, v0=v0)
    _check_order(order, data, n_rays, "record_paths")
    if int(nrec) < 1 or int(stride) < 1:
        raise ValueError(f"record_paths: nrec {nrec} and stride {stride} must be positive")
    path = torch.empty((int(nrec) * n_rays, 3), dtype=torch.float32, device=data.device)
    if n_rays:
        _launch_on_grid("record_paths", data, float(h), float(ds), x0.data_ptr(), v0.data_ptr(),
                        _ptr(order), path.data_ptr(), n_rays, int(nrec), int(stride))
    return path


def backtrace_path(numel: int, dtype: torch.dtype) -> str:
    """K3's path for a grid of ``numel`` elements of ``dtype``: ``"shared"`` where
    the whole gradient fits one block's shared memory, else ``"global"``."""
    size = torch.empty((), dtype=dtype).element_size()
    return "shared" if numel * size <= SHARED_BYTES_MAX else "global"


def backtrace(data: torch.Tensor, h: float, xt: torch.Tensor, vt: torch.Tensor,
              dx: torch.Tensor, dv: torch.Tensor, ds: float, max_steps: int,
              snap_tol: float, order: Optional[torch.Tensor] = None,
              tally: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: flat ``(D*H*W,)`` voxel gradient from exit state and cotangents.

    ``order`` as for :func:`trace_fwd`.  The path (:func:`backtrace_path`)
    follows from the grid's size and type alone.  ``tally``, for checks: an
    int64 ``(3,)`` tensor on the grid's device that the kernel adds to: the
    runs it flushed (the plain version's ``flushes``), the flushes it issued
    once the lanes of a warp had summed runs bound for the same stencil (8
    atomic adds each), and, on the shared path, the adds of the
    block-private gradients into the result.
    """
    _check_grid(data, "backtrace")
    n_rays = _check_rays(data, "backtrace", xt=xt, vt=vt, dx=dx, dv=dv)
    _check_order(order, data, n_rays, "backtrace")
    _check_tally(tally, data, "backtrace")
    g = torch.zeros((data.numel(),), dtype=data.dtype, device=data.device)
    if n_rays:
        path = backtrace_path(data.numel(), data.dtype)
        _launch_on_grid("backtrace", data, float(h), float(ds), float(snap_tol),
                        xt.data_ptr(), vt.data_ptr(), dx.data_ptr(), dv.data_ptr(),
                        _ptr(order), g.data_ptr(), _ptr(tally), n_rays, int(max_steps),
                        int(path == "shared"))
        BACKTRACE_PATHS[path] += 1
    return g


def _check_sdf(sdf: torch.Tensor, data: torch.Tensor, name: str) -> None:
    if sdf.device != data.device or sdf.dtype != data.dtype or sdf.shape != data.shape \
            or not sdf.is_contiguous():
        raise ValueError(f"{name}: sdf must be a contiguous {tuple(data.shape)} {data.dtype} "
                         f"tensor on {data.device}, got {sdf.dtype} {tuple(sdf.shape)} on "
                         f"{sdf.device}")


def trace_plane(data: torch.Tensor, h: float, x0: torch.Tensor, v0: torch.Tensor,
                pln_o: torch.Tensor, pln_d: torch.Tensor, ds: float, max_steps: int,
                order: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11: ``(xt, vt, miss)`` of the rays ``(x0, v0)`` stopping past their planes
    (``pln_o``, ``pln_d``: ``(N, 3)``); ``miss`` (bool) marks the rays that never
    escaped.  ``order`` as for :func:`trace_fwd`."""
    _check_grid(data, "trace_plane")
    n_rays = _check_rays(data, "trace_plane", x0=x0, v0=v0, pln_o=pln_o, pln_d=pln_d)
    _check_order(order, data, n_rays, "trace_plane")
    xt, vt = torch.empty_like(x0), torch.empty_like(v0)
    miss = torch.empty((n_rays,), dtype=torch.bool, device=data.device)
    if n_rays:
        _launch_on_grid("trace_plane", data, float(h), float(ds), x0.data_ptr(), v0.data_ptr(),
                        pln_o.data_ptr(), pln_d.data_ptr(), _ptr(order), xt.data_ptr(),
                        vt.data_ptr(), miss.data_ptr(), n_rays, int(max_steps))
    return xt, vt, miss


def _horizon(data: torch.Tensor, n_rays: int, words: int = 1) -> List[torch.Tensor]:
    """The state K12's and K13's pass 1 leaves for pass 2 (x, v, steps taken,
    inside, at each thread slot) and the words for the last escape step of
    the batch (one) or of each chunk (K17; zeroed), in the order of the
    kernels' arguments."""
    xv = torch.empty((2, n_rays, 3), dtype=data.dtype, device=data.device)
    return [xv[0], xv[1], torch.empty((n_rays,), dtype=torch.int32, device=data.device),
            torch.empty((n_rays,), dtype=torch.uint8, device=data.device),
            torch.zeros((words,), dtype=torch.int32, device=data.device)]


def trace_target(data: torch.Tensor, h: float, x0: torch.Tensor, v0: torch.Tensor,
                 target: torch.Tensor, ds: float, max_steps: int,
                 order: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K12: closest approach ``(xt, vt, d2)`` of the rays ``(x0, v0)`` to their
    ``target`` (``(N, 3)``), in two launches (to each ray's escape, then on to
    the batch's last escape).  ``order`` as for :func:`trace_fwd`."""
    _check_grid(data, "trace_target")
    n_rays = _check_rays(data, "trace_target", x0=x0, v0=v0, target=target)
    _check_order(order, data, n_rays, "trace_target")
    xt, vt = torch.empty_like(x0), torch.empty_like(v0)
    d2 = torch.empty((n_rays,), dtype=data.dtype, device=data.device)
    if n_rays:
        hz = _horizon(data, n_rays)
        for pass_ in (1, 2):
            _launch_on_grid("trace_target", data, float(h), float(ds), x0.data_ptr(),
                            v0.data_ptr(), target.data_ptr(), _ptr(order), xt.data_ptr(),
                            vt.data_ptr(), d2.data_ptr(), *map(_ptr, hz), n_rays, int(max_steps),
                            pass_)
    return xt, vt, d2


def node_pairs(data: torch.Tensor, sdf: torch.Tensor) -> torch.Tensor:
    """The ``(D, H, W, 2)`` grid of node pairs ``(data, sdf)`` that K13, K17
    and K19 read: each corner of both grids is one load at one address
    (``rules.cuh``, ``kSdfPacked``; K19's replay too).  Made as the real view of a complex
    tensor, one coalesced pass (at 128^3 f32 0.011 ms on an H100, where
    ``torch.stack`` along the last axis took 0.023)."""
    return torch.view_as_real(torch.complex(data, sdf))


def trace_sdf(data: torch.Tensor, sdf: torch.Tensor, h: float, x0: torch.Tensor,
              v0: torch.Tensor, ds: float, max_steps: int,
              order: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13: ``(xt, vt)`` of the rays ``(x0, v0)`` at their crossing out of
    ``sdf < 0`` (``sdf``: a grid of ``data``'s shape, type and spacing), in
    two launches as :func:`trace_target`, both reading the grids packed node
    by node (:func:`node_pairs`, made at each call).  ``order`` as for
    :func:`trace_fwd`."""
    _check_grid(data, "trace_sdf")
    _check_sdf(sdf, data, "trace_sdf")
    n_rays = _check_rays(data, "trace_sdf", x0=x0, v0=v0)
    _check_order(order, data, n_rays, "trace_sdf")
    xt, vt = torch.empty_like(x0), torch.empty_like(v0)
    if n_rays:
        pairs = node_pairs(data, sdf)
        hz = _horizon(data, n_rays)
        for pass_ in (1, 2):
            _launch_on_grid("trace_sdf", data, float(h), float(ds), pairs.data_ptr(),
                            x0.data_ptr(), v0.data_ptr(), _ptr(order), xt.data_ptr(),
                            vt.data_ptr(), *map(_ptr, hz), n_rays, int(max_steps), pass_)
    return xt, vt


def backtrace_sdf(data: torch.Tensor, sdf: torch.Tensor, h: float, xt: torch.Tensor,
                  vt: torch.Tensor, dx: torch.Tensor, dv: torch.Tensor, ds: float,
                  max_steps: int, snap_tol: float, order: Optional[torch.Tensor] = None,
                  tally: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K14: flat ``(D*H*W,)`` voxel gradient of ``data`` from the sdf trace's exit
    state and cotangents, summed in float64 (returned so; callers cast);
    ``sdf`` as for :func:`trace_sdf`; ``order`` and ``tally`` as for
    :func:`backtrace`; the path :func:`backtrace_path` of a float64 gradient,
    counted in :data:`BACKTRACE_SDF_PATHS`."""
    _check_grid(data, "backtrace_sdf")
    _check_sdf(sdf, data, "backtrace_sdf")
    n_rays = _check_rays(data, "backtrace_sdf", xt=xt, vt=vt, dx=dx, dv=dv)
    _check_order(order, data, n_rays, "backtrace_sdf")
    _check_tally(tally, data, "backtrace_sdf")
    g = torch.zeros((data.numel(),), dtype=torch.float64, device=data.device)
    if n_rays:
        path = backtrace_path(data.numel(), torch.float64)
        _launch_on_grid("backtrace_sdf", data, float(h), float(ds), float(snap_tol),
                        sdf.data_ptr(), xt.data_ptr(), vt.data_ptr(), dx.data_ptr(),
                        dv.data_ptr(), _ptr(order), g.data_ptr(), _ptr(tally), n_rays,
                        int(max_steps), int(path == "shared"))
        BACKTRACE_SDF_PATHS[path] += 1
    return g


def _check_slots(order: torch.Tensor, data: torch.Tensor, n_rays: int, name: str) -> int:
    """An order that picks the rays of one launch (all of them, or a chunk)."""
    if (order.device != data.device or order.dtype != torch.int32 or order.ndim != 1
            or order.shape[0] > n_rays or not order.is_contiguous()):
        raise ValueError(f"{name}: order must be a contiguous int32 (n,) tensor on "
                         f"{data.device} with n <= {n_rays}, got {order.dtype} "
                         f"{tuple(order.shape)} on {order.device}")
    return order.shape[0]


def trace_ckpt(data: torch.Tensor, h: float, x0: torch.Tensor, v0: torch.Tensor, ds: float,
               max_steps: int, seg: int, order: torch.Tensor, store_ckpts: bool = True,
               exit_state: bool = True):
    """K5: the exact path's forward pass over the rays ``order`` of ``(x0, v0)``.

    Returns ``(xt, vt, c, code, ckpts)``.  ``xt, vt`` (the exit state, K2's),
    ``c`` (int32 capture step, ``max_steps`` if none) and ``code`` (uint8: 0
    never escaped, 1 captured, 2 escaped without ever being inside) are in the
    rays' own order, for all ``N`` rays, ``None`` unless ``exit_state``;
    ``ckpts`` is the ``(ceil(max_steps/seg), 7, n)`` stack of ``(x, v,
    inside)`` of the ray ``order[i]`` in column ``i``, at each segment start
    before its escape (later entries are not written), ``None`` unless
    ``store_ckpts``: one field of the ``n`` rays to a row, so that a warp's
    store or load of a field is 32 neighbouring words.  ``order`` may pick a
    chunk of the rays (``n <= N``).
    """
    _check_grid(data, "trace_ckpt")
    n_rays = _check_rays(data, "trace_ckpt", x0=x0, v0=v0)
    n = _check_slots(order, data, n_rays, "trace_ckpt")
    if int(seg) < 1 or int(max_steps) < 0:
        raise ValueError(f"trace_ckpt: seg {seg} and max_steps {max_steps} must be positive")
    nseg = -(-int(max_steps) // int(seg))
    out = [None] * 5
    if exit_state:
        out[:4] = (torch.empty_like(x0), torch.empty_like(v0),
                   torch.empty((n_rays,), dtype=torch.int32, device=data.device),
                   torch.empty((n_rays,), dtype=torch.uint8, device=data.device))
    if store_ckpts:
        out[4] = torch.empty((nseg, CKPT_WIDTH, n), dtype=data.dtype, device=data.device)
    if n:
        _launch_on_grid("trace_ckpt", data, float(h), float(ds), x0.data_ptr(), v0.data_ptr(),
                        order.data_ptr(), *(_ptr(t) for t in out), n, int(max_steps),
                        int(seg))
    return tuple(out)


def _check_exact_inputs(name: str, data: torch.Tensor, ckpts: torch.Tensor, c: torch.Tensor,
                        code: torch.Tensor, n: int, n_rays: int) -> None:
    """The checkpoints of ``n`` slots, and ``c``, ``code`` of all ``n_rays`` rays,
    as the exact forward passes write them."""
    if (ckpts.device != data.device or ckpts.dtype != data.dtype or ckpts.ndim != 3
            or ckpts.shape[1:] != (CKPT_WIDTH, n) or not ckpts.is_contiguous()):
        raise ValueError(f"{name}: ckpts must be a contiguous (nseg, {CKPT_WIDTH}, "
                         f"{n}) {data.dtype} tensor on {data.device}, got "
                         f"{ckpts.dtype} {tuple(ckpts.shape)} on {ckpts.device}")
    for label, t, dtype in (("c", c, torch.int32), ("code", code, torch.uint8)):
        if t.device != data.device or t.dtype != dtype or t.shape != (n_rays,) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous {dtype} "
                             f"({n_rays},) tensor on {data.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _exact_out(data: torch.Tensor, out: Optional[torch.Tensor], name: str,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The flat ``(D*H*W,)`` sum an exact backward pass adds into (zeros when
    not given), of ``dtype`` (the grid's type unless given)."""
    dtype = dtype or data.dtype
    if out is None:
        return torch.zeros((data.numel(),), dtype=dtype, device=data.device)
    if (out.device != data.device or out.dtype != dtype
            or out.shape != (data.numel(),) or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous ({data.numel()},) "
                         f"{dtype} tensor on {data.device}")
    return out


def backtrace_exact(data: torch.Tensor, h: float, ckpts: torch.Tensor, c: torch.Tensor,
                    code: torch.Tensor, dx: torch.Tensor, dv: torch.Tensor, ds: float,
                    seg: int, order: torch.Tensor, out: Optional[torch.Tensor] = None,
                    tally: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6: the exact path's flat ``(D*H*W,)`` voxel gradient, added into ``out``.

    ``ckpts``, ``c``, ``code`` as :func:`trace_ckpt` (or
    :func:`trace_target_ckpt`) returned them for the same ``order``; ``dx,
    dv`` the cotangents of all ``N`` rays in their own order (``dv`` already
    zeroed for rays that never escaped, in the volume trace).  ``out`` (made
    zero when not given) takes the sum; ``tally``, for checks: an int64
    tensor of ``len(EXACT_TALLY)`` counters the kernel adds to
    (:data:`EXACT_TALLY`; K6 adds each run's 8 sums one by one, so its
    ``adds`` are 8 a flush issued and its ``float4_adds`` 0).
    """
    _check_grid(data, "backtrace_exact")
    n_rays = _check_rays(data, "backtrace_exact", dx=dx, dv=dv)
    n = _check_slots(order, data, n_rays, "backtrace_exact")
    _check_exact_inputs("backtrace_exact", data, ckpts, c, code, n, n_rays)
    out = _exact_out(data, out, "backtrace_exact")
    _check_tally(tally, data, "backtrace_exact", len(EXACT_TALLY))
    if n:
        _launch_on_grid("backtrace_exact", data, float(h), float(ds), ckpts.data_ptr(),
                        order.data_ptr(), c.data_ptr(), code.data_ptr(), dx.data_ptr(),
                        dv.data_ptr(), out.data_ptr(), _ptr(tally), n, ckpts.shape[0],
                        int(seg))
    return out


def _ckpt_outputs(data: torch.Tensor, x0: torch.Tensor, n: int, max_steps: int, seg: int,
                  store_ckpts: bool, name: str):
    """``xt, vt, c, code`` of all the rays and the ``(nseg, 7, n)`` checkpoints
    (``None`` unless ``store_ckpts``) of an exact variant's forward pass."""
    if int(seg) < 1 or int(max_steps) < 0:
        raise ValueError(f"{name}: seg {seg} and max_steps {max_steps} must be positive")
    nseg = -(-int(max_steps) // int(seg))
    n_rays = x0.shape[0]
    return (torch.empty_like(x0), torch.empty_like(x0),
            torch.empty((n_rays,), dtype=torch.int32, device=data.device),
            torch.empty((n_rays,), dtype=torch.uint8, device=data.device),
            torch.empty((nseg, CKPT_WIDTH, n), dtype=data.dtype, device=data.device)
            if store_ckpts else None)


def trace_plane_ckpt(data: torch.Tensor, h: float, x0: torch.Tensor, v0: torch.Tensor,
                     pln_o: torch.Tensor, pln_d: torch.Tensor, ds: float, max_steps: int,
                     seg: int, order: torch.Tensor, store_ckpts: bool = True):
    """K15: the plane variant's exact forward pass over the rays ``order``.

    Returns ``(xt, vt, miss, c, code, ckpts)``: K11's ``(xt, vt, miss)``,
    ``c`` and ``code`` as :func:`trace_ckpt`'s (``c`` is ``max_steps`` for a
    ray never captured), all at the rays' own indices (written for the rays
    of ``order`` only, which may be a chunk); ``ckpts`` as
    :func:`trace_ckpt`'s, ``None`` unless ``store_ckpts``."""
    _check_grid(data, "trace_plane_ckpt")
    n_rays = _check_rays(data, "trace_plane_ckpt", x0=x0, v0=v0, pln_o=pln_o, pln_d=pln_d)
    n = _check_slots(order, data, n_rays, "trace_plane_ckpt")
    xt, vt, c, code, ckpts = _ckpt_outputs(data, x0, n, max_steps, seg, store_ckpts,
                                           "trace_plane_ckpt")
    miss = torch.empty((n_rays,), dtype=torch.bool, device=data.device)
    if n:
        _launch_on_grid("trace_plane_ckpt", data, float(h), float(ds), x0.data_ptr(),
                        v0.data_ptr(), pln_o.data_ptr(), pln_d.data_ptr(), order.data_ptr(),
                        xt.data_ptr(), vt.data_ptr(), miss.data_ptr(), c.data_ptr(),
                        code.data_ptr(), _ptr(ckpts), n, int(max_steps), int(seg))
    return xt, vt, miss, c, code, ckpts


def trace_target_ckpt(data: torch.Tensor, h: float, x0: torch.Tensor, v0: torch.Tensor,
                      target: torch.Tensor, ds: float, max_steps: int, seg: int,
                      order: torch.Tensor, store_ckpts: bool = True,
                      horizon: Union[None, torch.Tensor,
                                     Callable[[torch.Tensor], torch.Tensor]] = None):
    """K16: the target variant's exact forward pass over the rays ``order``, in
    K12's two launches.

    Returns ``(xt, vt, d2, c, code, ckpts, horizon)``: K12's ``(xt, vt, d2)``,
    ``c`` (0 for a ray never captured) and ``code``, as :func:`trace_plane_ckpt`;
    the checkpoints run on past a ray's escape to the horizon; ``horizon`` is
    the int32 ``(1,)`` step at which the last ray escaped.  For a chunk of the
    rays, pass the whole batch's ``horizon`` (from the call on all of them):
    its rays then step on to it, as they do in the whole batch.  Or pass a
    function of pass 1's horizon that returns the one pass 2 takes (run
    between the two launches, also when ``order`` is empty): the sharded
    exact target gives the maximum over the ranks there."""
    _check_grid(data, "trace_target_ckpt")
    n_rays = _check_rays(data, "trace_target_ckpt", x0=x0, v0=v0, target=target)
    n = _check_slots(order, data, n_rays, "trace_target_ckpt")
    xt, vt, c, code, ckpts = _ckpt_outputs(data, x0, n, max_steps, seg, store_ckpts,
                                           "trace_target_ckpt")
    d2 = torch.empty((n_rays,), dtype=data.dtype, device=data.device)
    hz = _horizon(data, n)
    make = horizon if callable(horizon) else None
    if make is None and horizon is not None:
        hz[4] = _check_target_horizon(horizon, data).clone()
    for pass_ in (1, 2):
        if pass_ == 2 and make is not None:
            hz[4] = _check_target_horizon(make(hz[4]), data).contiguous()
        if n:
            _launch_on_grid("trace_target_ckpt", data, float(h), float(ds), x0.data_ptr(),
                            v0.data_ptr(), target.data_ptr(), order.data_ptr(), xt.data_ptr(),
                            vt.data_ptr(), d2.data_ptr(), c.data_ptr(), code.data_ptr(),
                            _ptr(ckpts), *map(_ptr, hz), n, int(max_steps), int(seg), pass_)
    return xt, vt, d2, c, code, ckpts, hz[4]


def _check_target_horizon(horizon: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    if not isinstance(horizon, torch.Tensor) or horizon.device != data.device \
            or horizon.dtype != torch.int32 or horizon.shape != (1,):
        raise ValueError(f"trace_target_ckpt: horizon must be an int32 (1,) tensor on "
                         f"{data.device}, got {horizon!r}")
    return horizon


def _check_horizons(horizons: torch.Tensor, data: torch.Tensor, n_rays: int) -> torch.Tensor:
    if (not isinstance(horizons, torch.Tensor) or horizons.device != data.device
            or horizons.dtype != torch.int32 or horizons.shape != (n_rays,)
            or not horizons.is_contiguous()):
        raise ValueError(f"trace_sdf_ckpt: horizons must be a contiguous int32 ({n_rays},) "
                         f"tensor on {data.device}")
    return horizons


def _sdf_chunk(chunk: int, n_rays: int) -> int:
    """The rays a word of K17's ``last`` takes: ``chunk``, or the whole batch
    where ``chunk`` is 0 or not below ``n_rays`` (the JAX package's
    ``_to_chunks``)."""
    return chunk if 0 < chunk < n_rays else max(n_rays, 1)


def sdf_chunk_horizons_plain(steps: torch.Tensor, order: torch.Tensor, chunk: int, seg: int,
                             max_steps: int) -> torch.Tensor:
    """K17's horizons as its two passes take them, in plain torch (the kernel
    is held to it through ``checkpointed._index_chunk_horizons``).

    ``steps``: pass 1's escape step at each thread slot (int32 ``(N,)``),
    slot ``i`` holding ray ``order[i]`` (every ray of the batch).  Pass 1
    takes the largest into the word of the slot's ray's chunk (ray index //
    chunk, :func:`_sdf_chunk`), and ray 0's also into the last chunk's word
    where copies of ray 0 pad it; pass 2 rounds the word of each ray's chunk
    up to a multiple of ``seg`` and caps it at ``max_steps``.  Returns the
    int32 ``(N,)`` horizons at the rays' own indices."""
    n = order.shape[0]
    chunk = _sdf_chunk(int(chunk), n)
    words = -(-n // chunk)
    word = order.long() // chunk
    last = torch.zeros((words,), dtype=torch.int64, device=steps.device)
    last = last.scatter_reduce(0, word, steps.long(), "amax")
    if words * chunk > n and n:
        last[-1] = torch.maximum(last[-1], steps.long()[order.long() == 0][0])
    hor = torch.clamp(-(-last // int(seg)) * int(seg), max=int(max_steps))
    return hor[torch.arange(n, device=steps.device) // chunk].to(torch.int32)


def target_retired_plain(x: torch.Tensor, v: torch.Tensor, target: torch.Tensor
                         ) -> torch.Tensor:
    """Where K12's and K16's pass 2 stops an escaped ray (``csrc/rules.cuh``,
    ``TargetRule::continues``), in plain torch: every axis recedes from the
    target or stands still, ``x_k >= t_k`` with ``v_k >= 0`` or ``x_k <= t_k``
    with ``v_k <= 0``.  ``x, v, target``: ``(N, 3)``; returns bool ``(N,)``.

    An escaped ray is outside the grid moving away on some axis, so its eval
    is masked, ``v`` stays fixed and each coordinate moves monotonically (a
    sum rounded to nearest is monotone).  From a state where this holds no
    ``|x_k - t_k|`` shrinks again, so the squared distance, three rounded
    squares summed in a fixed order, is never strictly below its running
    minimum: nothing of the ray changes after it."""
    away = ((x >= target) & (v >= 0)) | ((x <= target) & (v <= 0))
    return away.all(dim=-1)


def stencil_div_check(h: float, n_first: int = 16) -> Tuple[int, List[int]]:
    """The f32 stencil's division (``csrc/trilinear.cuh``, ``div_h``) against
    the operator on the card, for all 2^32 f32 dividends at the f32 spacing
    ``h``: how many quotients differ (NaN against NaN is no difference), and
    the bits of up to ``n_first`` of those dividends.  A check (``chip_smoke.py``
    runs it); not counted in :data:`LAUNCHES`, which counts the port's kernels."""
    fn = build.load("trace_fwd").anrt_div_h_check
    fn.argtypes, fn.restype = [_D, _VP, _VP, _I, _VP], _I
    count = torch.zeros((1,), dtype=torch.int64, device="cuda")
    first = torch.zeros((n_first,), dtype=torch.int32, device="cuda")
    err = fn(float(h), count.data_ptr(), first.data_ptr(), int(n_first),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"stencil_div_check: kernel launch failed with CUDA error {err}")
    n = int(count.item())
    return n, [int(b) & 0xFFFFFFFF for b in first[:min(n, n_first)].tolist()]


def exact_reciprocal(h: float) -> bool:
    """Whether the f64 spacing ``h`` is a power of two whose reciprocal f64
    holds exactly, so that the stencil's ``a / h`` is ``a * (1 / h)`` for
    every ``a`` (``csrc/trilinear.cuh``, ``exact_reciprocal``, whose twin
    this is: the f64 kernels multiply where it holds)."""
    m, e = math.frexp(float(h))
    return m == 0.5 and e >= -1022


#: the f64 dividends the division check always takes (then random ones)
DIV64_EDGES = (0.0, -0.0, math.inf, -math.inf, math.nan, 5e-324, -5e-324,
               2.2250738585072014e-308, -2.2250738585072014e-308, 2.225073858507201e-308,
               1.7976931348623157e308, -1.7976931348623157e308, 1.0, -1.0, 0.5, 64.0,
               1e-300, 1e300, 3.0, 1.0 / 3.0)


def stencil_div64_check(h: float, n: int = 1 << 32, seed: int = 0, n_first: int = 16
                        ) -> Tuple[int, List[float], bool]:
    """The f64 stencil's division (``csrc/trilinear.cuh``, ``div_h``: the
    exact multiply where :func:`exact_reciprocal` holds, else the operator)
    against the operator on the card at the f64 spacing ``h``, for the
    dividends :data:`DIV64_EDGES` and then random ones up to ``n`` (random
    bits, and numbers in [-128, 128)): how many quotients differ (NaN against
    NaN is none), up to ``n_first`` of those dividends, and whether the grid
    took the multiply.  A check; not counted in :data:`LAUNCHES`."""
    fn = build.load("trace_fwd").anrt_div_h64_check
    fn.argtypes = [_D, ctypes.c_ulonglong, ctypes.c_ulonglong, _VP, _I, _VP, _VP, _I, _VP, _VP]
    fn.restype = _I
    edge = torch.tensor(DIV64_EDGES, dtype=torch.float64, device="cuda")
    count = torch.zeros((1,), dtype=torch.int64, device="cuda")
    first = torch.zeros((n_first,), dtype=torch.int64, device="cuda")
    exact = ctypes.c_int(-1)
    err = fn(float(h), int(n), int(seed), edge.data_ptr(), edge.numel(), count.data_ptr(),
             first.data_ptr(), int(n_first), ctypes.byref(exact),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"stencil_div64_check: kernel launch failed with CUDA error {err}")
    k = int(count.item())
    bits = first[:min(k, n_first)].cpu()
    return k, bits.view(torch.float64).tolist(), bool(exact.value)


def trace_sdf_ckpt(data: torch.Tensor, sdf: torch.Tensor, h: float, x0: torch.Tensor,
                   v0: torch.Tensor, ds: float, max_steps: int, seg: int, order: torch.Tensor,
                   horizons: Union[torch.Tensor, int], store_ckpts: bool = True):
    """K17: the sdf variant's exact forward pass over the rays ``order``, in
    K13's two launches, reading K13's node pairs (:func:`node_pairs`, made at
    each call).

    Returns ``(xt, vt, c, code, ckpts, horizons)`` as :func:`trace_plane_ckpt`
    (``c`` 0 for a ray never captured); ``horizons`` (int32 ``(N,)``) the step
    each ray runs to while it is inside the sdf.  Given as a tensor (a chunk
    of the rays takes the whole batch's), or as an int, the rays of a chunk
    of the JAX package's exact forward (0: the whole batch), from which the
    kernel makes them (:func:`sdf_chunk_horizons_plain`): that needs
    ``order`` to hold every ray, and no launch runs between the passes."""
    _check_grid(data, "trace_sdf_ckpt")
    _check_sdf(sdf, data, "trace_sdf_ckpt")
    n_rays = _check_rays(data, "trace_sdf_ckpt", x0=x0, v0=v0)
    n = _check_slots(order, data, n_rays, "trace_sdf_ckpt")
    xt, vt, c, code, ckpts = _ckpt_outputs(data, x0, n, max_steps, seg, store_ckpts,
                                           "trace_sdf_ckpt")
    hor = hor_out = None
    chunk = words = 1
    if isinstance(horizons, torch.Tensor):
        hor = _check_horizons(horizons, data, n_rays)
    elif isinstance(horizons, int) and not isinstance(horizons, bool) and horizons >= 0:
        if n != n_rays:
            raise ValueError("trace_sdf_ckpt: a chunk of the rays needs the horizons of the "
                             "whole batch, not a chunk size")
        chunk = _sdf_chunk(horizons, n_rays)
        words = -(-n_rays // chunk)
        hor_out = torch.empty((n_rays,), dtype=torch.int32, device=data.device)
    else:
        raise ValueError(f"trace_sdf_ckpt: horizons must be an int32 ({n_rays},) tensor or a "
                         f"chunk size (int >= 0), got {horizons!r}")
    hz = _horizon(data, n, words)
    if n:
        pairs = node_pairs(data, sdf)
        for pass_ in (1, 2):
            _launch_on_grid("trace_sdf_ckpt", data, float(h), float(ds), pairs.data_ptr(),
                            x0.data_ptr(), v0.data_ptr(), order.data_ptr(), xt.data_ptr(),
                            vt.data_ptr(), c.data_ptr(), code.data_ptr(), _ptr(ckpts),
                            *map(_ptr, hz), _ptr(hor), _ptr(hor_out), n, int(max_steps),
                            int(seg), chunk, pass_)
    return xt, vt, c, code, ckpts, hor if hor is not None else hor_out


def backtrace_plane_exact(data: torch.Tensor, h: float, ckpts: torch.Tensor, c: torch.Tensor,
                          code: torch.Tensor, pln_o: torch.Tensor, pln_d: torch.Tensor,
                          dx: torch.Tensor, dv: torch.Tensor, ds: float, seg: int,
                          order: torch.Tensor, out: Optional[torch.Tensor] = None,
                          tally: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K18: the plane variant's exact flat voxel gradient, added into ``out``
    (the grid's type); ``ckpts``, ``c``, ``code`` as :func:`trace_plane_ckpt`
    returned them for the same ``order``, ``pln_o, pln_d, dx, dv`` ``(N, 3)``
    at the rays' own indices (``dx`` and ``dv`` already zeroed for the rays
    that missed); ``tally`` as for :func:`backtrace_exact`."""
    _check_grid(data, "backtrace_plane_exact")
    n_rays = _check_rays(data, "backtrace_plane_exact", pln_o=pln_o, pln_d=pln_d, dx=dx, dv=dv)
    n = _check_slots(order, data, n_rays, "backtrace_plane_exact")
    _check_exact_inputs("backtrace_plane_exact", data, ckpts, c, code, n, n_rays)
    out = _exact_out(data, out, "backtrace_plane_exact")
    _check_tally(tally, data, "backtrace_plane_exact", len(EXACT_TALLY))
    if n:
        _launch_on_grid("backtrace_plane_exact", data, float(h), float(ds), ckpts.data_ptr(),
                        order.data_ptr(), c.data_ptr(), code.data_ptr(), pln_o.data_ptr(),
                        pln_d.data_ptr(), dx.data_ptr(), dv.data_ptr(), out.data_ptr(),
                        _ptr(tally), n, ckpts.shape[0], int(seg))
    return out


def backtrace_sdf_exact(data: torch.Tensor, sdf: torch.Tensor, h: float, ckpts: torch.Tensor,
                        c: torch.Tensor, code: torch.Tensor, dx: torch.Tensor, dv: torch.Tensor,
                        ds: float, seg: int, order: torch.Tensor,
                        out: Optional[torch.Tensor] = None,
                        tally: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K19: the sdf variant's exact flat voxel gradient, added into ``out``
    (float64 whatever the grid's type), from :func:`trace_sdf_ckpt`'s
    checkpoints for the same ``order``, its replay reading K17's node pairs
    (:func:`node_pairs`, made at each call); otherwise as
    :func:`backtrace_exact`."""
    _check_grid(data, "backtrace_sdf_exact")
    _check_sdf(sdf, data, "backtrace_sdf_exact")
    n_rays = _check_rays(data, "backtrace_sdf_exact", dx=dx, dv=dv)
    n = _check_slots(order, data, n_rays, "backtrace_sdf_exact")
    _check_exact_inputs("backtrace_sdf_exact", data, ckpts, c, code, n, n_rays)
    out = _exact_out(data, out, "backtrace_sdf_exact", torch.float64)
    _check_tally(tally, data, "backtrace_sdf_exact", len(EXACT_TALLY))
    if n:
        pairs = node_pairs(data, sdf)
        _launch_on_grid("backtrace_sdf_exact", data, float(h), float(ds), pairs.data_ptr(),
                        ckpts.data_ptr(), order.data_ptr(), c.data_ptr(), code.data_ptr(),
                        dx.data_ptr(), dv.data_ptr(), out.data_ptr(), _ptr(tally), n,
                        ckpts.shape[0], int(seg))
    return out


#: K8's block size on its column path (``kColumnThreads`` in csrc/cylinder.cuh)
CABLE_COLUMN_THREADS = 32


def cable_shared_bytes(res: int, dtype: torch.dtype, slots: int) -> int:
    """The shared memory of one block of a cable kernel on a profile of ``res``
    bins: the per-bin table (four words a bin) and ``slots`` float64 gradients
    (0 for K7 and K9, 1 for the adjoints' block gradient, a lane's column each
    on K8's column path; csrc/cylinder.cuh)."""
    item = torch.empty((), dtype=dtype).element_size()
    return res * (4 * item + 8 * slots)


def backtrace_cable_path(res: int, dtype: torch.dtype) -> str:
    """K8's path for a profile of ``res`` bins of ``dtype``: ``"columns"`` (each
    lane adds its splats to its own column of the block's gradient) where a
    block of :data:`CABLE_COLUMN_THREADS` lanes' columns fits shared memory,
    else ``"block"`` (one gradient a block, a ray's runs added to it)."""
    fits = cable_shared_bytes(res, dtype, CABLE_COLUMN_THREADS) <= SHARED_BYTES_MAX
    return "columns" if fits else "block"


#: the steps of one of K10's two replay buffers (``kCableReplay`` in
#: csrc/backtrace_cable_exact.cu); a longer segment is replayed in stretches
CABLE_REPLAY = 32
#: the most blocks of K10 on its block path, each with two replay buffers in
#: device memory (at most 51 MB in f32, 101 MB in f64): no fewer than an H100
#: runs at once at any profile size that path takes (12 blocks an SM at its
#: smallest); a block takes every ``CABLE_EXACT_BLOCK_GRID``-th group of rays
CABLE_EXACT_BLOCK_GRID = 2048


def cable_replay_bytes(dtype: torch.dtype) -> int:
    """One of K10's replay buffers: the positions of :data:`CABLE_REPLAY`
    steps of its block's 32 rays and a 4-byte word of active steps a ray."""
    item = torch.empty((), dtype=dtype).element_size()
    return 32 * (CABLE_REPLAY * 3 * item + 4)


def cable_exact_shared_bytes(res: int, dtype: torch.dtype, slots: int) -> int:
    """K10's shared memory a block on its column path: :func:`cable_shared_bytes`
    plus its two replay buffers.  (Its block path keeps them in device memory
    and needs K8's ``cable_shared_bytes(res, dtype, 1)``.)"""
    return cable_shared_bytes(res, dtype, slots) + 2 * cable_replay_bytes(dtype)


def backtrace_cable_exact_path(res: int, dtype: torch.dtype) -> str:
    """K10's path for a profile of ``res`` bins of ``dtype``, by K8's rule
    (:func:`backtrace_cable_path`) with its replay buffers counted in:
    ``"columns"`` (each adjoint lane's own column of the block's gradient)
    where they fit shared memory, else ``"block"``."""
    fits = cable_exact_shared_bytes(res, dtype, CABLE_COLUMN_THREADS) <= SHARED_BYTES_MAX
    return "columns" if fits else "block"


def _check_profile(data: torch.Tensor, name: str, slots: int = 0) -> None:
    """Raises on a profile the kernel does not take: the wrong type or shape, more
    bins than a block's shared memory holds (:func:`cable_shared_bytes`), or off
    the card."""
    if data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: profile must be float32 or float64, got {data.dtype}")
    if data.ndim != 1 or not data.is_contiguous() or data.shape[0] < 2:
        raise ValueError(f"{name}: profile must be a contiguous (res,) tensor with res >= 2, "
                         f"got shape {tuple(data.shape)}")
    need = cable_shared_bytes(data.shape[0], data.dtype, slots)
    if need > SHARED_BYTES_MAX:
        raise ValueError(f"{name}: a profile of {data.shape[0]} bins needs {need} bytes of a "
                         f"block's shared memory, more than its {SHARED_BYTES_MAX}")
    if not data.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got a profile on {data.device}")


def _launch_on_profile(name: str, data: torch.Tensor, radius: float, length: float,
                       ds: float, *args) -> None:
    """:func:`_launch` for the cable kernels, whose first arguments are the profile."""
    _launch(name, data.device, int(data.dtype == torch.float64), data.data_ptr(),
            data.shape[0], float(radius), float(length), float(ds), *args)


def _grad_out(data: torch.Tensor, out: Optional[torch.Tensor], name: str) -> torch.Tensor:
    """The float64 ``(res,)`` sum the cable adjoints add into (zeros when not given)."""
    if out is None:
        return torch.zeros((data.shape[0],), dtype=torch.float64, device=data.device)
    if (out.device != data.device or out.dtype != torch.float64
            or out.shape != (data.shape[0],) or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous float64 ({data.shape[0]},) tensor "
                         f"on {data.device}")
    return out


def trace_cable(data: torch.Tensor, radius: float, length: float, x0: torch.Tensor,
                v0: torch.Tensor, target: torch.Tensor, ds: float, max_steps: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7: closest approach ``(xt, vt, d2)`` of the rays ``(x0, v0)`` to their
    ``target`` (N, 3) in the cylinder of the profile ``data`` (res,)."""
    _check_profile(data, "trace_cable")
    n_rays = _check_rays(data, "trace_cable", x0=x0, v0=v0, target=target)
    xt, vt = torch.empty_like(x0), torch.empty_like(v0)
    d2 = torch.empty((n_rays,), dtype=data.dtype, device=data.device)
    if n_rays:
        _launch_on_profile("trace_cable", data, radius, length, ds, x0.data_ptr(),
                           v0.data_ptr(), target.data_ptr(), xt.data_ptr(), vt.data_ptr(),
                           d2.data_ptr(), n_rays, int(max_steps))
    return xt, vt, d2


def backtrace_cable(data: torch.Tensor, radius: float, length: float, xt: torch.Tensor,
                    vt: torch.Tensor, dx: torch.Tensor, dv: torch.Tensor, ds: float,
                    max_steps: int, cap: float, out: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """K8: the profile gradient from the closest approach and its cotangents,
    summed in float64 into ``out`` (made zero when not given) and returned.
    ``cap`` is the cap-plane snap tolerance ``tol * radius``.  The path
    (:func:`backtrace_cable_path`) follows from the profile's size and type."""
    _check_profile(data, "backtrace_cable", slots=1)
    n_rays = _check_rays(data, "backtrace_cable", xt=xt, vt=vt, dx=dx, dv=dv)
    out = _grad_out(data, out, "backtrace_cable")
    if n_rays:
        path = backtrace_cable_path(data.shape[0], data.dtype)
        _launch_on_profile("backtrace_cable", data, radius, length, ds, float(cap),
                           xt.data_ptr(), vt.data_ptr(), dx.data_ptr(), dv.data_ptr(),
                           out.data_ptr(), n_rays, int(max_steps), int(path == "columns"))
        BACKTRACE_CABLE_PATHS[path] += 1
    return out


def trace_cable_ckpt(data: torch.Tensor, radius: float, length: float, x0: torch.Tensor,
                     v0: torch.Tensor, target: torch.Tensor, ds: float, max_steps: int,
                     seg: int, store_ckpts: bool = True, exit_state: bool = True):
    """K9: the exact cable gradient's forward pass.

    Returns ``(xt, vt, d2, c, ckpts)``: K7's closest approach and ``c``
    (int32, the step whose state became the output, 0 if none), ``None``
    unless ``exit_state``; ``ckpts`` the ``(ceil(max_steps/seg), 7, N)``
    stack of ``(x, v, esc)`` at each segment start before the ray froze
    (later entries are not written), ``None`` unless ``store_ckpts``.
    """
    _check_profile(data, "trace_cable_ckpt")
    n_rays = _check_rays(data, "trace_cable_ckpt", x0=x0, v0=v0, target=target)
    if int(seg) < 1 or int(max_steps) < 0:
        raise ValueError(f"trace_cable_ckpt: seg {seg} and max_steps {max_steps} must be "
                         "positive")
    nseg = -(-int(max_steps) // int(seg))
    out = [None] * 5
    if exit_state:
        out[:4] = (torch.empty_like(x0), torch.empty_like(v0),
                   torch.empty((n_rays,), dtype=data.dtype, device=data.device),
                   torch.empty((n_rays,), dtype=torch.int32, device=data.device))
    if store_ckpts:
        out[4] = torch.empty((nseg, CKPT_WIDTH, n_rays), dtype=data.dtype, device=data.device)
    if n_rays:
        _launch_on_profile("trace_cable_ckpt", data, radius, length, ds, x0.data_ptr(),
                           v0.data_ptr(), target.data_ptr(), *(_ptr(t) for t in out),
                           n_rays, int(max_steps), int(seg))
    return tuple(out)


def backtrace_cable_exact(data: torch.Tensor, radius: float, length: float,
                          ckpts: torch.Tensor, c: torch.Tensor, dx: torch.Tensor,
                          dv: torch.Tensor, ds: float, seg: int,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K10: the exact cable gradient, summed in float64 into ``out`` (made zero
    when not given) and returned; ``ckpts`` and ``c`` as :func:`trace_cable_ckpt`
    returned them for the same rays, ``dx, dv`` their cotangents.  The path
    (:func:`backtrace_cable_exact_path`) follows from the profile's size and
    type."""
    _check_profile(data, "backtrace_cable_exact", slots=1)
    n_rays = _check_rays(data, "backtrace_cable_exact", dx=dx, dv=dv)
    if (ckpts.device != data.device or ckpts.dtype != data.dtype or ckpts.ndim != 3
            or ckpts.shape[1:] != (CKPT_WIDTH, n_rays) or not ckpts.is_contiguous()):
        raise ValueError(f"backtrace_cable_exact: ckpts must be a contiguous (nseg, "
                         f"{CKPT_WIDTH}, {n_rays}) {data.dtype} tensor on {data.device}, got "
                         f"{ckpts.dtype} {tuple(ckpts.shape)} on {ckpts.device}")
    if c.device != data.device or c.dtype != torch.int32 or c.shape != (n_rays,) \
            or not c.is_contiguous():
        raise ValueError(f"backtrace_cable_exact: c must be a contiguous int32 ({n_rays},) "
                         f"tensor on {data.device}, got {c.dtype} {tuple(c.shape)} on {c.device}")
    out = _grad_out(data, out, "backtrace_cable_exact")
    if n_rays:
        path = backtrace_cable_exact_path(data.shape[0], data.dtype)
        grid = min(-(-n_rays // 32), CABLE_EXACT_BLOCK_GRID)
        buffers = None if path == "columns" else torch.empty(
            (2 * grid * cable_replay_bytes(data.dtype),), dtype=torch.uint8, device=data.device)
        _launch_on_profile("backtrace_cable_exact", data, radius, length, ds, ckpts.data_ptr(),
                           c.data_ptr(), dx.data_ptr(), dv.data_ptr(), out.data_ptr(), n_rays,
                           ckpts.shape[0], int(seg), int(path == "columns"), _ptr(buffers),
                           grid)
        BACKTRACE_CABLE_EXACT_PATHS[path] += 1
    return out


def _check_slab(slab: torch.Tensor, res: Tuple[int, int, int], z_first: int, name: str) -> None:
    """A slab: a contiguous ``(rows, H, W)`` window of a ``(D, H, W)`` grid that
    holds at least one cell row (``rows >= 2``) and starts in ``[-1, D)``."""
    _check_grid(slab, name)
    d, hgt, wid = res
    rows = slab.shape[0]
    if slab.shape[1:] != (hgt, wid) or rows < 2 or not -1 <= z_first < d:
        raise ValueError(f"{name}: slab {tuple(slab.shape)} at row {z_first} is not a window "
                         f"of a {tuple(res)} grid")


def _check_states(data: torch.Tensor, n: int, name: str, **arrays: torch.Tensor) -> None:
    for label, (t, dtype) in arrays.items():
        if t is None:
            continue
        if t.device != data.device or t.dtype != dtype or t.shape != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous {dtype} ({n},) tensor on "
                             f"{data.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


class _SlabLaunch:
    """K21 or K22 on one slab and the rays' state, the checks made by the
    caller: each call is one launch that steps the rays whose cell row lies in
    the given voxel-row windows of the slab (csrc/slab.cu's ``Sweep``).  It
    holds every tensor whose address it passes (``tensors``), so that none is
    freed, and its memory handed to another, while launches may still read
    it."""

    def __init__(self, name: str, slab: torch.Tensor, z_first: int, geometry: tuple,
                 tensors: tuple, start: torch.Tensor, gate: torch.Tensor, n: int,
                 max_steps: int, inner: int):
        self.name, self.fn, self.device = name, _kernel(name), slab.device
        self.stream = torch.cuda.current_stream(slab.device)
        self.tensors = (slab, *tensors, start, gate)
        self.head = (int(slab.dtype == torch.float64), slab.data_ptr(), *geometry, int(z_first),
                     slab.shape[0], *(_ptr(t) for t in tensors))
        self.sweep = (start.data_ptr(), gate.data_ptr())
        self.tail = (n, int(max_steps), int(inner))

    def __call__(self, windows, init: bool, flags: Optional[torch.Tensor]) -> None:
        (f0, r0), (f1, r1) = (list(windows) + [(0, 0)])[:2]
        args = (*self.head, *self.sweep, _ptr(flags), int(init), int(f0), int(r0), int(f1),
                int(r1), *self.tail)
        if torch.cuda.current_device() == self.device.index:
            _run(self.name, self.fn, self.stream, args)
        else:
            with torch.cuda.device(self.device):
                _run(self.name, self.fn, self.stream, args)


def _slab_trace_sweep(name, slab, res, z_first, h, ds, x, v, xt, vt, inside, esc, cnt,
                      max_steps, inner, order, planes):
    """K21's checks, once, and the phase function of its launches
    (:func:`_sweep_phase`)."""
    _check_slab(slab, res, z_first, name)
    extra = {} if planes is None else dict(pln_o=planes[0], pln_d=planes[1])
    n = _check_rays(slab, name, x=x, v=v, xt=xt, vt=vt, **extra)
    _check_states(slab, n, name, inside=(inside, torch.bool), esc=(esc, torch.bool),
                  cnt=(cnt, torch.int32))
    _check_order(order, slab, n, name)
    start, gate = cnt.clone(), torch.empty_like(cnt)
    d, hgt, wid = res
    tensors = (order, x, v, xt, vt, inside, esc, cnt, *((None, None) if planes is None
                                                        else planes))
    launch = _SlabLaunch("slab_trace_phase", slab, z_first, (wid, hgt, d, float(h), float(ds)),
                         tensors, start, gate, n, max_steps, inner) if n else None
    return _sweep_phase(launch, slab, int(z_first), name)


def _slab_backtrace_sweep(name, slab, res, z_first, h, ds, snap_tol, x, v, la, mu, active,
                          cnt, gslab, max_steps, inner, order):
    """K22's checks, once, and the phase function of its launches."""
    _check_slab(slab, res, z_first, name)
    if gslab.device != slab.device or gslab.dtype != slab.dtype or gslab.shape != slab.shape \
            or not gslab.is_contiguous():
        raise ValueError(f"{name}: gslab must be a contiguous {tuple(slab.shape)} {slab.dtype} "
                         f"tensor on {slab.device}")
    n = _check_rays(slab, name, x=x, v=v, la=la, mu=mu)
    _check_states(slab, n, name, active=(active, torch.bool), cnt=(cnt, torch.int32))
    _check_order(order, slab, n, name)
    start, gate = cnt.clone(), torch.empty_like(cnt)
    d, hgt, wid = res
    launch = _SlabLaunch("slab_backtrace_phase", slab, z_first,
                         (wid, hgt, d, float(h), float(ds), float(snap_tol)),
                         (order, x, v, la, mu, active, cnt, gslab), start, gate, n, max_steps,
                         inner) if n else None
    return _sweep_phase(launch, slab, int(z_first), name)


def _check_windows(slab: torch.Tensor, z_first: int, windows, name: str):
    """At most two voxel-row windows ``(first, rows)`` of the slab."""
    windows = [(int(f), int(r)) for f, r in windows]
    if len(windows) > 2 or any(r < 0 or f < z_first or f + r > z_first + slab.shape[0]
                               for f, r in windows):
        raise ValueError(f"{name}: bands {windows} are not at most two windows of the slab's "
                         f"rows [{z_first}, {z_first + slab.shape[0]})")
    return windows


def _sweep_phase(launch: Optional[_SlabLaunch], slab: torch.Tensor, z_first: int, name: str):
    """The ``phase(windows, first, last)`` that ``parallel.slabs.sweep_bands``
    takes, on the launcher of one phase; ``windows`` in the slab's own rows."""

    def phase(windows, first, last):
        bands = _check_windows(slab, z_first, [(z_first + lo, rows) for lo, rows in windows],
                               name)
        flags = torch.zeros((2,), dtype=torch.int32, device=slab.device) if last else None
        if launch is not None:
            launch(bands, first, flags)
        return flags

    return phase


_WAVES: dict = {}


def slab_wave(device: torch.device, dtype: torch.dtype, backward: bool,
              plane: bool = False) -> int:
    """The rays one wave of K21 (``backward`` False; ``plane``: K11's rule) or
    K22 holds on ``device``: the blocks an SM runs at once at the kernel's
    occupancy, times the SMs, times the 128 threads a block."""
    key = (torch.device(device), dtype, bool(backward), bool(plane))
    if key not in _WAVES:
        fn = build.load("slab_trace_phase").anrt_slab_wave
        fn.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        fn.restype = _I
        rays = _I(0)
        with torch.cuda.device(key[0]):
            err = fn(int(dtype == torch.float64), int(backward), int(plane), ctypes.byref(rays))
        if err != 0:
            raise RuntimeError(f"slab_wave: CUDA error {err}")
        _WAVES[key] = rays.value
    return _WAVES[key]


def slab_trace_phase(slab: torch.Tensor, res: Tuple[int, int, int], z_first: int, h: float,
                     ds: float, x: torch.Tensor, v: torch.Tensor, xt: torch.Tensor,
                     vt: torch.Tensor, inside: torch.Tensor, esc: torch.Tensor,
                     cnt: torch.Tensor, max_steps: int, inner: int,
                     order: Optional[torch.Tensor] = None,
                     planes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """K21: one forward phase of the slab ring as one launch over the whole slab, in place.

    ``slab`` holds the voxel rows ``[z_first, z_first + rows)`` of a grid of
    shape ``res`` ``(D, H, W)``; the rays' state ``x, v, xt, vt`` ``(N, 3)``,
    ``inside``, ``esc`` (bool) and ``cnt`` (int32) is stepped by up to
    ``inner`` steps a ray while the ray's cell row is in the slab, it has not
    escaped and ``cnt < max_steps``; ``planes`` ``(pln_o, pln_d)`` selects
    K11's rule.  ``order`` as for :func:`trace_fwd`.  Returns the int32
    ``(1,)`` word that is 1 where a ray has steps left (not read back).  It
    is :func:`slab_trace_bands`'s phase function on the slab as one window;
    the ring runs a phase as a band sweep of it.
    """
    phase = _slab_trace_sweep("slab_trace_phase", slab, res, z_first, h, ds, x, v, xt, vt,
                              inside, esc, cnt, max_steps, inner, order, planes)
    return phase([(0, slab.shape[0])], True, True)[:1]


def slab_trace_bands(slab: torch.Tensor, res: Tuple[int, int, int], z_first: int, h: float,
                     ds: float, x: torch.Tensor, v: torch.Tensor, xt: torch.Tensor,
                     vt: torch.Tensor, inside: torch.Tensor, esc: torch.Tensor,
                     cnt: torch.Tensor, max_steps: int, inner: int,
                     order: Optional[torch.Tensor] = None,
                     planes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """K21 for one phase run as a band sweep (``parallel.slabs.sweep_bands``).

    The arguments as :func:`slab_trace_phase`'s, checked once; the step counts
    at the phase's start and the gate are made here.  Returns ``phase(windows,
    first, last)``: one launch of K21 on the rays whose cell row lies in the
    given windows ``(lo, rows)`` of the slab's own voxel rows (``first``
    writes the gate), which on a sweep's last launch (``last``) returns the
    ``[pending, live]`` words."""
    return _slab_trace_sweep("slab_trace_bands", slab, res, z_first, h, ds, x, v, xt, vt,
                             inside, esc, cnt, max_steps, inner, order, planes)


def slab_backtrace_phase(slab: torch.Tensor, res: Tuple[int, int, int], z_first: int, h: float,
                         ds: float, snap_tol: float, x: torch.Tensor, v: torch.Tensor,
                         la: torch.Tensor, mu: torch.Tensor, active: torch.Tensor,
                         cnt: torch.Tensor, gslab: torch.Tensor, max_steps: int, inner: int,
                         order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K22: one adjoint phase of the slab ring as one launch over the slab, in place.

    ``slab`` as for :func:`slab_trace_phase`; ``gslab`` (the slab's shape and
    type) takes the splats; the state ``x, v, la, mu`` ``(N, 3)``,
    ``active`` (bool), ``cnt`` (int32) steps as K3's rays do while each ray's
    snapped position lies in a cell row of the slab.  ``order`` and what it
    returns as for :func:`slab_trace_phase`; the ring's band sweep:
    :func:`slab_backtrace_bands`.
    """
    phase = _slab_backtrace_sweep("slab_backtrace_phase", slab, res, z_first, h, ds, snap_tol,
                                  x, v, la, mu, active, cnt, gslab, max_steps, inner, order)
    return phase([(0, slab.shape[0])], True, True)[:1]


def slab_backtrace_bands(slab: torch.Tensor, res: Tuple[int, int, int], z_first: int, h: float,
                         ds: float, snap_tol: float, x: torch.Tensor, v: torch.Tensor,
                         la: torch.Tensor, mu: torch.Tensor, active: torch.Tensor,
                         cnt: torch.Tensor, gslab: torch.Tensor, max_steps: int, inner: int,
                         order: Optional[torch.Tensor] = None):
    """K22 for one phase run as a band sweep, as :func:`slab_trace_bands` is K21's."""
    return _slab_backtrace_sweep("slab_backtrace_bands", slab, res, z_first, h, ds, snap_tol,
                                 x, v, la, mu, active, cnt, gslab, max_steps, inner, order)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K4: ``out[i] = table[idx[i]]`` for a ``(R, L)`` table and ``(N,)`` indices.

    ``table`` is f32 or f64 with a row of whole 16-byte vectors (``L`` a
    multiple of 4 for f32, of 2 for f64); ``idx`` is int32 or int64 on the
    table's device.  Indices outside ``[0, R)`` are the caller's error: the
    kernel does not check them and the wrapper does not scan them (a scan
    would read the whole index vector once more and synchronise).
    """
    if table.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gather_rows: table must be float32 or float64, got {table.dtype}")
    if table.ndim != 2 or not table.is_contiguous() or table.shape[0] == 0:
        raise ValueError(f"gather_rows: table must be a contiguous, non-empty (R, L) tensor, "
                         f"got shape {tuple(table.shape)}, strides {table.stride()}")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes == 0 or row_bytes % _VEC_BYTES or table.data_ptr() % _VEC_BYTES:
        raise ValueError(f"gather_rows: a row must be whole {_VEC_BYTES}-byte vectors on a "
                         f"{_VEC_BYTES}-byte aligned table, got rows of {row_bytes} bytes at "
                         f"address {table.data_ptr():#x}")
    if row_bytes // _VEC_BYTES > _INT_MAX:
        raise ValueError(f"gather_rows: rows of {row_bytes} bytes are outside the kernel's "
                         "int32 indexing")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gather_rows: idx must be int32 or int64, got {idx.dtype}")
    if idx.device != table.device or idx.ndim != 1 or not idx.is_contiguous():
        raise ValueError(f"gather_rows: idx must be a contiguous (N,) tensor on {table.device}, "
                         f"got shape {tuple(idx.shape)} on {idx.device}")
    if not table.is_cuda:
        raise ValueError(f"gather_rows: the kernel takes CUDA tensors, got a table on "
                         f"{table.device}")
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    if idx.shape[0]:
        _launch("gather_rows", table.device, int(idx.dtype == torch.int64), table.data_ptr(),
                idx.data_ptr(), out.data_ptr(), idx.shape[0], row_bytes // _VEC_BYTES)
    return out
