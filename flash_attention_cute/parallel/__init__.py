"""Multi-chip parallelism: mesh construction, parameter/cache shardings,
and shard_map-wrapped attention.

The reference is single-process single-GPU (SURVEY.md §2.4: no
torch.distributed anywhere); this subsystem is the scale-out layer it
lacks: a ('data', 'model') mesh, tensor-parallel weight and KV-cache
shardings with GQA head co-location, and XLA collectives (NCCL on the
GPU) inserted by GSPMD.
"""

from flash_attention_cute.parallel.mesh import make_mesh
from flash_attention_cute.parallel.sharding import (
    cache_pspecs,
    param_pspecs,
    shard_cache,
    shard_params,
    sharded_attention,
)
from flash_attention_cute.parallel.sequence import (
    allgather_attention,
    ring_attention,
)

__all__ = [
    "make_mesh",
    "param_pspecs",
    "cache_pspecs",
    "shard_params",
    "shard_cache",
    "sharded_attention",
    "allgather_attention",
    "ring_attention",
]
