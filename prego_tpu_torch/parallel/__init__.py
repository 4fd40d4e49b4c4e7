from prego_tpu_torch.parallel.mesh import (
    Mesh,
    PartitionSpec,
    make_mesh,
    run_ranks,
    shard,
    tp_mesh,
)
from prego_tpu_torch.parallel.sharding import (
    llama_cache_specs,
    llama_param_specs,
    llama_tp_config,
    shard_params,
)

__all__ = [
    "make_mesh",
    "shard",
    "tp_mesh",
    "llama_cache_specs",
    "llama_param_specs",
    "shard_params",
    "Mesh",
    "PartitionSpec",
    "llama_tp_config",
    "run_ranks",
]
