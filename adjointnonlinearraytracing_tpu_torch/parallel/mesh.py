"""Ray parallelism over processes: the ray mesh and the sharded traces.

Twin of ``adjointnonlinearraytracing_tpu/parallel/mesh.py``.  The JAX package
shards the ray batch over a 1D device mesh (axis "rays") with ``shard_map``:
the grid is replicated, each device traces its shard, and the voxel-gradient
partials are summed with one ``psum`` at the end of the adjoint sweep.  Here
a device is a process (``torch.distributed``, one GPU a process: NCCL for
CUDA tensors, gloo for CPU tensors), and the contract is JAX's global-array
view:

* the caller passes the whole batch, on every rank;
* each rank traces its contiguous shard of ``N / world_size`` rays (the
  caller pads the batch to a multiple: :func:`pad_rays`, or
  ``experiments.common.make_trace``'s copies of ray 0);
* the outputs are ``all_gather``-ed, so every rank holds the whole batch's;
* the backward pass sums the ranks' voxel gradients with one ``all_reduce``
  (SUM), so every rank holds the whole gradient (JAX's ``psum``).

With no process group initialised the mesh has one rank and no collective
runs: one process, one card.  The kernels are the unsharded path's (K2 and
K3, K5 and K6), launched on the shard.

Not here yet: the variant builders ``make_sharded_trace_{plane,target,sdf,
cable}`` raise (``ROADMAP.md`` A15b); the target's and the sdf's horizons
need a cross-shard maximum (the JAX ``pmax``) with tests of its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..tracer import api
from ..tracer import checkpointed as CK
from ..tracer import compaction as CP


@dataclass(frozen=True)
class RayMesh:
    """A 1D mesh of ``world_size`` processes over the ray axis; this process
    is ``rank``.  ``group`` is the process group of the collectives (None:
    the default group, or no collectives at world size 1)."""

    world_size: int = 1
    rank: int = 0
    group: Optional["dist.ProcessGroup"] = None

    def shard(self, n: int) -> slice:
        """This rank's contiguous rays of a batch of ``n`` (a multiple of the world size)."""
        if n % self.world_size:
            raise ValueError(f"a batch of {n} rays does not divide into {self.world_size} "
                             "shards: pad it first (pad_rays)")
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' equal shards ``t`` concatenated along axis 0, in rank order."""
        if self.world_size == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` summed (``t`` itself at world size 1)."""
        if self.world_size == 1:
            return t
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t


def make_ray_mesh(group=None) -> RayMesh:
    """The mesh over the processes of ``group`` (the default group), or a mesh
    of one where no process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        return RayMesh()
    return RayMesh(dist.get_world_size(group), dist.get_rank(group), group)


def pad_rays(x: torch.Tensor, n_shards: int, axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad the ray axis with zeros to a multiple of ``n_shards``; returns
    ``(padded, mask)``, ``mask`` true for the real rays.  The padding rays
    must be left out of a loss through the mask."""
    n = x.shape[axis]
    rem = (-n) % n_shards
    mask = torch.arange(n + rem, device=x.device) < n
    if rem == 0:
        return x, mask
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=axis), mask


def shard_rays(mesh: RayMesh, *arrays: torch.Tensor):
    """This rank's shard of each ray array (axis 0)."""
    out = tuple(a[mesh.shard(a.shape[0])] for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh: RayMesh, a: torch.Tensor) -> torch.Tensor:
    """``a`` as rank 0 holds it, on every rank (broadcast in place)."""
    if mesh.world_size > 1:
        dist.broadcast(a, src=0, group=mesh.group)
    return a


class _SumGrad(torch.autograd.Function):
    """The identity on the field; backward, its gradient summed over the
    mesh's ranks (JAX's ``psum`` of the voxel-gradient partials)."""

    @staticmethod
    def forward(ctx, rif, mesh):
        ctx.mesh = mesh
        return rif

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g), None


class _Gather(torch.autograd.Function):
    """This rank's shard ``t`` of rows ``sl`` -> the whole batch's, on every
    rank; backward, the rows ``sl`` of the cotangent (every rank's loss reads
    the whole batch, so each holds the whole cotangent)."""

    @staticmethod
    def forward(ctx, t, mesh, sl):
        ctx.sl = sl
        return mesh.all_gather(t)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.sl], None, None


def _sharded(mesh: RayMesh, name: str, local):
    """``name(rif, x, v) -> (xt, vt)`` over the mesh: ``local`` traces this
    rank's shard on a field whose gradient is summed over the ranks, and the
    outputs are gathered."""

    def traced(rif, x, v):
        api._check_rif(rif, name)
        api._check_rays(x, v, name)
        sl = mesh.shard(x.shape[0])
        xt, vt = local(_SumGrad.apply(rif, mesh), x[sl], v[sl])
        return _Gather.apply(xt, mesh, sl), _Gather.apply(vt, mesh, sl)

    return traced


def make_sharded_trace(mesh: RayMesh, h: float, ds: float, res_max: int, nbuckets: int = 0):
    """A differentiable ``trace(rif, x, v) -> (xt, vt)`` sharded over the mesh's rays.

    Forward: each rank traces its shard (K2) and the exit states are
    gathered.  Backward: each rank's adjoint (K3) on its shard's cotangents,
    the voxel gradients summed over the ranks.  ``nbuckets > 1`` applies
    exit-step compaction inside each shard
    (:func:`tracer.compaction.trace_bucketed`: each bucket's adjoint keeps its
    forward pass's order); a shard that ``nbuckets`` does not divide is traced
    whole.  The outputs equal ``api.trace``'s bit for bit and the gradient up
    to the order of its sums.  ``res_max`` is the grid's largest side, for the
    JAX signature: the step bounds follow from the grid the closure is called
    with.
    """
    del res_max  # the steps follow from rif's shape, as api.trace's do
    h, ds, nbuckets = float(h), float(ds), int(nbuckets)
    return _sharded(mesh, "make_sharded_trace",
                    lambda r, x, v: CP.trace_bucketed(r, x, v, h, ds, nbuckets))


def make_sharded_trace_exact(mesh: RayMesh, h: float, ds: float, res_max: int, seg: int = 32):
    """The sharded ``trace_exact(rif, x, v) -> (xt, vt)``: the exact gradient
    over the mesh's rays.

    Forward: each rank's exit states (K5, no checkpoints kept), gathered.
    Backward: each rank recomputes the checkpoints of each of its
    ``ANRT_EXACT_CHUNK`` chunks (K5) and replays them (K6), with the ``vt``
    cotangent of its never-escaped rays zeroed; the voxel gradients summed
    over the ranks.  Memory is bounded by the chunk at any batch size.
    """
    del res_max
    h, ds, seg = float(h), float(ds), int(seg)
    if seg < 1:
        raise ValueError(f"make_sharded_trace_exact: seg must be a positive step count, got {seg}")
    return _sharded(mesh, "make_sharded_trace_exact",
                    lambda r, x, v: CK._TraceExact.apply(r, x, v, h, ds, seg, False))


def _later(name: str):
    def builder(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: the sharded variants need the cross-shard horizon of the target and "
            "the sdf (the JAX pmax) and are not in this port yet (ROADMAP.md A15b)")
    builder.__name__ = name
    builder.__doc__ = f"Raises: ``{name}`` is not ported yet (``ROADMAP.md`` A15b)."
    return builder


make_sharded_trace_plane = _later("make_sharded_trace_plane")
make_sharded_trace_target = _later("make_sharded_trace_target")
make_sharded_trace_sdf = _later("make_sharded_trace_sdf")
make_sharded_trace_cable = _later("make_sharded_trace_cable")

__all__ = ["RayMesh", "make_ray_mesh", "pad_rays", "shard_rays", "replicate",
           "make_sharded_trace", "make_sharded_trace_exact", "make_sharded_trace_plane",
           "make_sharded_trace_target", "make_sharded_trace_sdf", "make_sharded_trace_cable"]
