"""Ray-parallel weak scaling over ranks (one process a card).

Twin of ``adjointnonlinearraytracing_tpu/benchmarks/scaling.py``: rays/s of a
forward + gradient step through ``parallel.make_sharded_trace`` (each rank K2
and K3 on its shard, the exit states gathered, the gradient summed) at 1, 2,
4, ... ranks with the rays scaled in proportion, and the parallel efficiency
against one rank.  Under ``torchrun`` the sweep runs on sub-groups of the
first 1, 2, 4, ... ranks (``torch.distributed.new_group``; the ranks outside
a sub-group wait at the barrier); without a process group it measures one
rank.  Rank 0 prints and returns the rows; the others return ``[]``.

Run:  torchrun --standalone --nproc_per_node 4 -m adjointnonlinearraytracing_tpu_torch.benchmarks.scaling
      python -m adjointnonlinearraytracing_tpu_torch.benchmarks.scaling
(``--res``, ``--rays-per-device``, ``--iters``; ``--device cpu`` runs gloo
processes on the CPU.)
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from ..convert import require_device
from ..parallel.distributed import process_info
from ..parallel.mesh import RayMesh, make_sharded_trace
from ..utils import profiling
from .scenes import build_case


def profile_scaling(res=17, rays_per_device=1 << 12, iters=2, span=20.0, device="cuda"):
    """One row a rank count ``n`` (1, 2, 4, ... up to the world size): ``n``
    ranks trace ``n * rays_per_device`` rays, each its shard."""
    info = process_info()
    world, rank = info["process_count"], info["process_index"]
    dev = require_device(device)
    if dev.type == "cuda" and world > 1:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    h = span / (res - 1)
    ds = h / 2
    rows, base = [], None
    for n in [n for n in (1, 2, 4, 8, 16, 32) if n <= world]:
        group = dist.new_group(list(range(n))) if world > 1 else None
        if rank < n:
            nrays = rays_per_device * n
            rif, x0, v0, _ = build_case(res=res, nrays=nrays, span=span, device=dev)
            mesh = RayMesh(n, rank, group)
            traced = make_sharded_trace(mesh, h, ds, res)

            def step():
                r = rif.detach().requires_grad_(True)
                xt, _ = traced(r, x0, v0)
                (xt ** 2).sum().backward()
                return r.grad

            dt = profiling.timeit(step, iters=iters, warmup=1, device=dev)
            if n > 1:  # the slowest rank's time is the step's
                t = torch.tensor([dt], dtype=torch.float64, device=dev)
                dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
                dt = float(t)
            rps = nrays / dt
            base = rps if base is None else base
            row = dict(devices=n, rays=nrays, time_s=round(dt, 6), rays_per_s=round(rps, 1),
                       efficiency=round(rps / (base * n), 3))
            if rank == 0:
                rows.append(row)
                print(json.dumps(row), flush=True)
        if world > 1:
            dist.barrier()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=17)
    ap.add_argument("--rays-per-device", type=int, default=1 << 12)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    kw = dict(res=args.res, rays_per_device=args.rays_per_device, iters=args.iters,
              device=args.device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # started by torchrun
        dist.init_process_group("nccl" if require_device(args.device).type == "cuda" else "gloo")
        try:
            profile_scaling(**kw)
        finally:
            dist.destroy_process_group()
    else:
        profile_scaling(**kw)


if __name__ == "__main__":
    main()
