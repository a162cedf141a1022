"""Data and tensor parallelism (counterpart of maua_tpu/parallel):
torch.distributed process groups for training, device lists for
frame-parallel rendering, and channel-sharded synthesis over a (data x model)
DeviceMesh (`tp`)."""

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
from .tp import MODEL_AXIS, TensorParallelGenerator, generator_param_shardings, get_2d_mesh, shard_generator_params

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "TensorParallelGenerator",
    "all_reduce_mean_",
    "all_reduce_mean_tree",
    "all_reduce_sum",
    "gather_batch",
    "generator_param_shardings",
    "get_2d_mesh",
    "get_mesh",
    "is_main_process",
    "local_device_count",
    "local_rows",
    "maybe_initialize_distributed",
    "pad_to_multiple",
    "process_count",
    "process_device",
    "process_index",
    "shard_generator_params",
    "shard_batch",
    "shutdown_distributed",
    "tree_rows",
]
