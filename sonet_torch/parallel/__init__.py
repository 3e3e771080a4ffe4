"""The (data, points) device mesh over several processes (port of the JAX
package's ``parallel/``): ``mesh`` builds the mesh and places batches,
``distributed`` brings up the process group and moves values between
processes, ``collectives`` holds the reductions inside the model and
their gradients (imported on its own: it needs torch, and this package
is imported by ``config``, which must not)."""

from .mesh import (make_mesh, mesh_for_config, batch_specs, shard_batch,
                   shard_stacked, replicate,
                   parse_mesh_shape, normalize_mesh_shape,
                   check_mesh_divisible)
from .distributed import (maybe_init_distributed, parse_distributed_spec,
                          is_main, fetch_global, process_count, sync)

__all__ = ["make_mesh", "mesh_for_config", "batch_specs", "shard_batch",
           "shard_stacked", "replicate",
           "parse_mesh_shape", "normalize_mesh_shape",
           "check_mesh_divisible",
           "maybe_init_distributed", "parse_distributed_spec", "is_main",
           "fetch_global", "process_count", "sync"]
