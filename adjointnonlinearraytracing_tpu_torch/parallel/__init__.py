"""Ray parallelism over processes (``torch.distributed``); twin of the JAX
package's ``parallel`` (the mesh and the process helpers; ``slabs.py`` and
the sharded variants are ``ROADMAP.md`` A15b)."""

from .mesh import (
    RayMesh,
    make_ray_mesh,
    make_sharded_trace,
    make_sharded_trace_plane,
    make_sharded_trace_target,
    make_sharded_trace_sdf,
    make_sharded_trace_cable,
    make_sharded_trace_exact,
    pad_rays,
    shard_rays,
    replicate,
)
from .distributed import (initialize, process_info, local_ray_slice, global_ray_array,
                          rank0_value)
