from .mesh import (all_gather, all_reduce, axis_group, axis_rank, barrier,
                   batch_sharding, broadcast, broadcast_object,
                   choose_backend, full_tensor, init_rank, launch,
                   local_device, make_mesh, mesh_axis_size, rank_zero,
                   replicated, shard_batch, shard_rows)
from .partition import (FREEZE_FLAG_PREFIXES, fsdp_sharding, gather_rows,
                        gather_with_local_grads, trainable_mask)
from .tp import apply_tp, tp_sharding

__all__ = ["FREEZE_FLAG_PREFIXES", "all_gather", "all_reduce", "apply_tp",
           "axis_group", "axis_rank", "barrier", "batch_sharding",
           "broadcast", "broadcast_object", "choose_backend",
           "fsdp_sharding", "full_tensor", "gather_rows",
           "gather_with_local_grads", "init_rank", "launch", "local_device",
           "make_mesh", "mesh_axis_size", "rank_zero", "replicated",
           "shard_batch", "shard_rows", "tp_sharding", "trainable_mask"]
