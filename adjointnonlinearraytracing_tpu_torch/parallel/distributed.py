"""Process-level set-up and helpers of the ray mesh.

Twin of ``adjointnonlinearraytracing_tpu/parallel/distributed.py``.  The JAX
package calls ``jax.distributed.initialize`` once per host and builds its mesh
over every global device; here each process drives one device, so the mesh's
ranks are the processes of a ``torch.distributed`` group (``parallel/
mesh.py``).  Nothing on the card's machine tells a program of a cluster: the
caller gives the address (``host:port``), the number of processes and this
process's index.

The helpers keep the JAX package's pad-and-mask convention:
:func:`local_ray_slice` gives this process's contiguous range of the padded
global batch, so that each process draws only its own rays, and
:func:`global_ray_array` assembles the processes' ranges into the whole batch
on every process (the sharded traces take the whole batch).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group; nothing to do for one process or a group that exists.

    ``coordinator_address`` is ``host:port`` of rank 0 (``None``: the
    ``MASTER_ADDR`` / ``MASTER_PORT`` environment, as ``torch.distributed``
    reads it); ``backend`` defaults to NCCL where there is a GPU (each process
    then takes the device ``process_id % device_count``) and gloo otherwise.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and process_id is not None:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}" if coordinator_address else "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def process_info():
    """This process's place: its index, the process count, and the devices
    (one a process)."""
    count, index = _world()
    return dict(process_index=index, process_count=count, local_devices=1,
                global_devices=count)


def local_ray_slice(n_global: int, n_shards: Optional[int] = None):
    """This process's contiguous ray range of the pad-and-mask global batch.

    The global batch is padded up to a multiple of ``n_shards`` (default: the
    process count) and split evenly across the processes.  Returns ``(start,
    stop, n_valid)``: every process draws ``stop - start`` rays; rays with a
    global index ``>= n_global`` are the trailing pad and must be masked
    (``parallel.mesh.pad_rays``'s convention), and ``n_valid`` is how many
    of this process's rays are real.
    """
    pc, pi = _world()
    if n_shards is None:
        n_shards = pc
    n_shards = max(n_shards, pc)
    padded = -(-n_global // n_shards) * n_shards
    per = padded // pc
    start, stop = pi * per, (pi + 1) * per
    n_valid = max(0, min(stop, n_global) - start)
    return start, stop, n_valid


def rank0_value(value: float, device) -> float:
    """``value`` as rank 0 of the default group holds it, on every process (the
    value itself in one process): a decision that each rank would take from
    its own rounding (the stage escalation's spot check) is taken once.
    ``device`` is where the collective runs: the rank's GPU under NCCL."""
    count, _ = _world()
    if count == 1:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    dist.broadcast(t, src=0)
    return float(t)


def global_ray_array(mesh, local_arrays) -> List[torch.Tensor]:
    """The processes' ray ranges (axis 0, equal lengths) concatenated in rank
    order: the whole batch on every process, as the sharded traces take it."""
    return [mesh.all_gather(torch.as_tensor(a)) for a in local_arrays]
