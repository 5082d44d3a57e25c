"""The (data, fsdp, model) mesh over torch.distributed (port of teochat_tpu/parallel/)."""

from teochat_torch.parallel.mesh import create_mesh, init_distributed, local_mesh, mesh_shape
from teochat_torch.parallel.sharding import batch_spec, param_specs, placement_specs, shard_params
from teochat_torch.parallel.tensor_parallel import Sharded

__all__ = [
    "create_mesh",
    "init_distributed",
    "local_mesh",
    "mesh_shape",
    "param_specs",
    "placement_specs",
    "shard_params",
    "batch_spec",
    "Sharded",
]
