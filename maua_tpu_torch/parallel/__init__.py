"""Data parallelism (counterpart of maua_tpu/parallel): torch.distributed
process groups for training, device lists for frame-parallel rendering. The
tensor-parallel names of maua_tpu/parallel/tp.py are not ported yet."""

from .mesh import (
    DATA_AXIS,
    all_reduce_mean_,
    all_reduce_mean_tree,
    all_reduce_sum,
    gather_batch,
    get_mesh,
    is_main_process,
    local_device_count,
    local_rows,
    maybe_initialize_distributed,
    pad_to_multiple,
    process_count,
    process_device,
    process_index,
    shard_batch,
    shutdown_distributed,
    tree_rows,
)

__all__ = [
    "DATA_AXIS",
    "all_reduce_mean_",
    "all_reduce_mean_tree",
    "all_reduce_sum",
    "gather_batch",
    "get_mesh",
    "is_main_process",
    "local_device_count",
    "local_rows",
    "maybe_initialize_distributed",
    "pad_to_multiple",
    "process_count",
    "process_device",
    "process_index",
    "shard_batch",
    "shutdown_distributed",
    "tree_rows",
]
