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
K3, K5 and K6; the variants' K3, K6 and K7-K19), launched on the shard.

The variants (``make_sharded_trace_{plane,target,sdf,cable}``) keep the horizons of
the JAX functions, which are not all the whole batch's:

* the plain target and the plain sdf run the unsharded trace on each shard,
  so a ray steps on after its escape to **its shard's** last escape, not
  the batch's (the JAX ``while_loop`` stops on its shard's ``all(esc)``):
  a ray whose closest approach (or late sdf crossing) comes after that step
  reports another ``xt``, ``d2`` than the unsharded call gives it, the one
  the unsharded call on its shard gives;
* the exact target takes the **global** horizon: each rank's last escape
  step, the maximum over the ranks (the JAX ``pmax``, an ``all_reduce`` with
  ``MAX`` here), for the forward pass and the backward's recomputation, so
  it equals the unsharded ``trace_target_exact``;
* the exact sdf skips segments by the escapes of its shard's
  ``ANRT_EXACT_CHUNK`` chunks, as the unsharded call does by the whole
  batch's chunks (no collective);
* the plane and the cable stop a ray at its own escape: sharded or not,
  the same result.

The z-slab ring of ``parallel/slabs.py`` adds two collectives to the mesh:
the ring shift (:meth:`RayMesh.shift`, JAX's ``ppermute``) and the integer
maximum (:meth:`RayMesh.all_max`, JAX's ``pmax``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..tracer import api
from ..tracer import checkpointed as CK
from ..tracer import compaction as CP
from ..tracer.api import bcast_per_ray3


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

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' elementwise maximum of ``t`` (JAX's ``pmax``; ``t`` itself at
        world size 1)."""
        if self.world_size == 1:
            return t
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def _peer(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def shift(self, t: torch.Tensor, back: bool = False,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The ring shift: ``t`` goes to rank ``rank + 1`` and the tensor rank
        ``rank - 1`` sent comes back (JAX's ``ppermute`` with ``perm``), or the
        other way round with ``back`` (``perm_back``).  ``out`` (``t``'s shape
        and type) takes it, if given; ``t`` itself at world size 1."""
        if self.world_size == 1:
            return t
        t = t.contiguous()
        out = torch.empty_like(t) if out is None else out
        ahead, behind = (self.rank + 1) % self.world_size, (self.rank - 1) % self.world_size
        to, frm = (behind, ahead) if back else (ahead, behind)
        ops = [dist.P2POp(dist.isend, t, self._peer(to), self.group),
               dist.P2POp(dist.irecv, out, self._peer(frm), self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


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


def _gather_plain(mesh: RayMesh, t: torch.Tensor) -> torch.Tensor:
    """A non-differentiable per-ray output (``miss``, ``d2``) of the shards,
    gathered (a bool one through uint8, which every backend moves)."""
    if t.dtype == torch.bool:
        return mesh.all_gather(t.to(torch.uint8)).to(torch.bool)
    return mesh.all_gather(t)


def _on_shards(mesh: RayMesh, local, rif, per_ray, shared=()):
    """``local(rif, *shared, *shard)`` on this rank's shard of the per-ray
    tensors ``per_ray`` (``x``, ``v``, then planes or targets, each ``(N,
    3)``), with ``rif``'s gradient summed over the ranks; its first two
    outputs ``(xt, vt)`` are gathered with their cotangents, the rest
    (``miss``, ``d2``) plainly."""
    sl = mesh.shard(per_ray[0].shape[0])
    out = local(_SumGrad.apply(rif, mesh), *shared, *(t[sl] for t in per_ray))
    return (_Gather.apply(out[0], mesh, sl), _Gather.apply(out[1], mesh, sl),
            *(_gather_plain(mesh, t) for t in out[2:]))


def _checked_rays(name, rif, x, v, **per_ray):
    """``[x, v, *per_ray]`` after the unsharded calls' checks, the planes or
    targets as ``(N, 3)``."""
    api._check_rif(rif, name)
    api._check_rays(x, v, name)
    for label, p in per_ray.items():
        api._check_per_ray3(p, x, label, name)
    return [x, v] + [bcast_per_ray3(p, x) for p in per_ray.values()]


def _sharded(mesh: RayMesh, name: str, local):
    """``name(rif, x, v) -> (xt, vt)`` over the mesh: ``local`` traces this
    rank's shard on a field whose gradient is summed over the ranks, and the
    outputs are gathered."""
    return lambda rif, x, v: _on_shards(mesh, local, rif, _checked_rays(name, rif, x, v))


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
    h, ds = float(h), float(ds)
    seg = _check_seg("make_sharded_trace_exact", seg)
    return _sharded(mesh, "make_sharded_trace_exact",
                    lambda r, x, v: CK._TraceExact.apply(r, x, v, h, ds, seg, False))


def _check_seg(name: str, seg: int) -> int:
    if int(seg) < 1:
        raise ValueError(f"{name}: seg must be a positive step count, got {seg}")
    return int(seg)


def make_sharded_trace_plane(mesh: RayMesh, h: float, ds: float, res_max: int,
                             exact: bool = False, seg: int = 32):
    """The sharded ``trace_plane(rif, x, v, pln_o, pln_d) -> (xt, vt, miss)``.

    Each rank traces its shard (``api.trace_plane``: K11, then K3 with the
    missed rays' position cotangent zeroed; ``exact=True``:
    ``trace_plane_exact``, K15 then K18, both cotangents of missed rays
    zeroed); outputs gathered, the gradient summed over the ranks.  The
    planes are ``(N, 3)`` or one for every ray.  Only ``rif`` gets a
    gradient.  A ray stops at its own escape, so the result is the unsharded
    call's.
    """
    del res_max
    h, ds = float(h), float(ds)
    seg = _check_seg("make_sharded_trace_plane", seg)

    def local(r, x, v, o, d):
        if exact:
            return CK.trace_plane_exact(r, x, v, o, d, h, ds, seg)
        return api.trace_plane(r, x, v, o, d, h, ds)

    def traced(rif, x, v, pln_o, pln_d):
        rays = _checked_rays("make_sharded_trace_plane", rif, x, v, pln_o=pln_o, pln_d=pln_d)
        return _on_shards(mesh, local, rif, rays)

    return traced


def make_sharded_trace_target(mesh: RayMesh, h: float, ds: float, res_max: int,
                              exact: bool = False, seg: int = 32):
    """The sharded ``trace_target(rif, x, v, target) -> (xt, vt, d2)``.

    Plain: each rank runs ``api.trace_target`` (K12's two launches, then K3)
    on its shard, so its rays step on to **the shard's** last escape, as the
    JAX functions' do: a ray whose closest approach comes later than that
    differs from the unsharded call.  ``exact=True``: ``trace_target_exact``
    (K16, then K6) with the **global** horizon, the maximum over the ranks of
    their last escape steps (``all_reduce`` with ``MAX`` between K16's two
    launches, or of ``_target_stop_step`` on the CPU), for the forward pass
    and the backward's recomputation: the unsharded call's result.  Only
    ``rif`` gets a gradient.
    """
    del res_max
    h, ds = float(h), float(ds)
    seg = _check_seg("make_sharded_trace_target", seg)

    def local(r, x, v, t):
        if exact:
            return CK._variant_exact("target", r, None, x, v, t, None, h, ds, seg,
                                     stop_all=mesh.all_max)
        return api.trace_target(r, x, v, t, h, ds)

    def traced(rif, x, v, target):
        rays = _checked_rays("make_sharded_trace_target", rif, x, v, target=target)
        return _on_shards(mesh, local, rif, rays)

    return traced


def make_sharded_trace_sdf(mesh: RayMesh, h: float, ds: float, res_max: int,
                           exact: bool = False, seg: int = 32):
    """The sharded ``trace_sdf(rif, sdf, x, v) -> (xt, vt)``, both grids on
    every rank, ``int(2 * h * max(res) / ds)`` steps.

    Plain: ``api.trace_sdf`` (K13's two launches, K14) on each shard, each
    to its shard's horizon.  ``exact=True``: ``trace_sdf_exact`` (K17, K19)
    on each shard, whose segment skip follows the shard's
    ``ANRT_EXACT_CHUNK`` chunks, as the JAX function's does.  Only ``rif``
    gets a gradient (summed over the ranks); the sdf's is zero.
    """
    del res_max
    h, ds = float(h), float(ds)
    seg = _check_seg("make_sharded_trace_sdf", seg)

    def local(r, sdf, x, v):
        if exact:
            return CK.trace_sdf_exact(r, sdf, x, v, h, ds, seg)
        return api.trace_sdf(r, sdf, x, v, h, ds)

    def traced(rif, sdf, x, v):
        rays = _checked_rays("make_sharded_trace_sdf", rif, x, v)
        if sdf.shape != rif.shape:
            raise ValueError(f"make_sharded_trace_sdf: sdf grid {tuple(sdf.shape)} must match "
                             f"rif {tuple(rif.shape)}")
        return _on_shards(mesh, local, rif, rays, shared=(sdf,))

    return traced


def make_sharded_trace_cable(mesh: RayMesh, radius: float, length: float, ds: float,
                             exact: bool = False, seg: int = 32):
    """The sharded ``trace_cable(rif, x, v, target) -> (xt, vt, d2)``: the 1D
    radial profile ``rif`` on every rank, its gradient summed over them;
    ``int(4 * length / ds)`` steps.

    Each rank runs ``api.trace_cable`` (K7, K8; ``exact=True``:
    ``trace_cable_exact``, K9, K10) on its shard.  A cable ray freezes at its
    escape, so no ray's result depends on its batch and the sharded outputs
    are the unsharded call's.  Only ``rif`` gets a gradient.
    """
    radius, length, ds = float(radius), float(length), float(ds)
    seg = _check_seg("make_sharded_trace_cable", seg)

    def local(r, x, v, t):
        if exact:
            return CK.trace_cable_exact(r, radius, length, x, v, t, ds, seg)
        return api.trace_cable(r, radius, length, x, v, t, ds)

    def traced(rif, x, v, target):
        api._check_cable(rif, x, v, target, "make_sharded_trace_cable")
        return _on_shards(mesh, local, rif, [x, v, bcast_per_ray3(target, x)])

    return traced


__all__ = ["RayMesh", "make_ray_mesh", "pad_rays", "shard_rays", "replicate",
           "make_sharded_trace", "make_sharded_trace_exact", "make_sharded_trace_plane",
           "make_sharded_trace_target", "make_sharded_trace_sdf", "make_sharded_trace_cable"]
