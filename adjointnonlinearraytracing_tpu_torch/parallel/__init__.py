"""Ray parallelism over processes (``torch.distributed``); twin of the JAX
package's ``parallel``: the ray mesh, the sharded traces and their variants
(``mesh.py``), the process helpers (``distributed.py``) and the z-slab ring
(``slabs.py``)."""

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
from .slabs import (slab_rows, pad_rif_z, build_slab_tables, make_slab_trace_zsharded,
                    make_slab_trace)
