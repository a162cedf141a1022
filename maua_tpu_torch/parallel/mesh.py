"""Process groups, device lists and the collectives of data parallelism
(counterpart of maua_tpu/parallel/mesh.py).

The JAX package expresses both of the reference's parallel strategies as one
`data` mesh that XLA shards batches over. The port splits them as the
reference did:

* Data-parallel training is one process per card. `maybe_initialize_distributed`
  opens the `torch.distributed` process group (NCCL for a CUDA device, gloo
  for the CPU) over `tcp://<coordinator>`; every rank holds whole copies of
  the networks and takes a contiguous block of the global batch
  (`shard_batch`). Gradients are summed over the ranks and divided by the
  world size (`all_reduce_mean_`), which is the mean over the global batch.
  `gather_batch` lays the ranks' blocks end to end in rank order, so a
  cross-sample statistic (the minibatch stddev, the path-length mean) sees the
  global batch, and it is differentiable to any order: its backward sums the
  gradient over the ranks and keeps this rank's block.
* Frame-parallel rendering stays in one process: a mesh is a list of torch
  devices (`get_mesh`), each of which takes a slice of every frame batch.

Every helper is an identity in a process without a process group, so the same
code runs single-process. GSPMD's sharding objects (`batch_sharding`,
`train_batch_sharding`, `replicated`) have no counterpart: parameters are
replicated by construction and a batch is split with `shard_batch`.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

DATA_AXIS = "data"


def get_mesh(devices: Optional[Sequence[DeviceLike]] = None) -> list[torch.device]:
    """The devices of a frame-parallel render in this process: `devices`, or
    every visible CUDA card (RuntimeError when there is none)."""
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [resolve_device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def local_device_count() -> int:
    return torch.cuda.device_count()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0 writes checkpoints, metrics, samples and wandb logs."""
    return process_index() == 0


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0) -> tuple[torch.Tensor, int]:
    """Zero-pad dim `axis` up to a multiple of `multiple`; returns (padded,
    original length)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=axis), n


def shard_batch(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous block of dim `axis` (the whole tensor in a
    process without a process group). The dim must divide by the world size."""
    world = process_count()
    if world == 1:
        return x
    n = x.shape[axis]
    if n % world:
        raise ValueError(f"dim {axis} of size {n} does not split over {world} processes")
    return x.narrow(axis, process_index() * (n // world), n // world)


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place, through one
    flat buffer (no-op without a process group)."""
    if not dist.is_initialized() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


def all_reduce_mean_tree(tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """{name: mean over the ranks} of a dict of 0-d tensors (the reference's
    reduce_loss_dict); the dict itself without a process group."""
    if not dist.is_initialized() or not tree:
        return tree
    keys = sorted(tree)
    vals = [tree[k].detach().float().reshape(1).clone() for k in keys]
    all_reduce_mean_(vals)
    return {**tree, **{k: v.reshape(()) for k, v in zip(keys, vals)}}


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks (a new tensor; `x` without a process group)."""
    if not dist.is_initialized():
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out


class _GatherRows(torch.autograd.Function):
    """[b, ...] on each rank -> [world * b, ...], rank blocks in rank order."""

    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        return _SumRows.apply(grad)


class _SumRows(torch.autograd.Function):
    """The adjoint of _GatherRows: sum the [world * b, ...] gradients over the
    ranks and keep this rank's block."""

    @staticmethod
    def forward(ctx, grad):
        total = grad.contiguous().clone()
        dist.all_reduce(total)
        return total.chunk(dist.get_world_size())[dist.get_rank()].clone()

    @staticmethod
    def backward(ctx, grad):
        return _GatherRows.apply(grad)


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Every rank's [b, ...] block laid end to end, differentiable to any
    order; `x` itself without a process group. Every rank must call it."""
    if not dist.is_initialized():
        return x
    return _GatherRows.apply(x)


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a gathered [world * b, ...] tensor."""
    if not dist.is_initialized():
        return x
    return x.chunk(dist.get_world_size())[dist.get_rank()]


def maybe_initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
) -> bool:
    """Open the default process group when a coordinator is given (the flag,
    or COORDINATOR_ADDRESS with NUM_PROCESSES and PROCESS_ID): `tcp://` to
    `host:port`, NCCL when `device` is a CUDA device (one process per card,
    this process on `cuda:{process_id % device_count}`), gloo on the CPU.
    A no-op without a coordinator; idempotent. Returns whether a process
    group is open."""
    coord = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if coord and not dist.is_initialized():
        world = num_processes if num_processes is not None else int(os.environ.get("NUM_PROCESSES", "1"))
        rank = process_id if process_id is not None else int(os.environ.get("PROCESS_ID", "0"))
        if not 0 <= rank < world:
            raise ValueError(f"process_id {rank} is outside [0, {world})")
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=f"tcp://{coord}",
                                world_size=world, rank=rank)
    return dist.is_initialized()


def process_device(device: DeviceLike = None) -> torch.device:
    """The device of this process: `cuda:{local rank}` for a CUDA device
    under a process group, else `device` resolved."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dist.is_initialized():
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev


def shutdown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def tree_rows(tree: Any, axis: int = 0) -> Any:
    """`shard_batch` over every tensor of a (nested) list / tuple / NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return shard_batch(tree, axis)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_rows(t, axis) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_rows(t, axis) for t in tree)
    return tree
