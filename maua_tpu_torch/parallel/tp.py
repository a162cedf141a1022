"""Tensor-parallel (channel-sharded) synthesis (counterpart of
maua_tpu/parallel/tp.py).

The rule is the JAX package's: shard the out-channel axis of every
StyledConv's modulated-conv weight and of its activation bias over the
`model` axis of a (data x model) mesh, where the channel count divides by the
axis; replicate everything else (the mapping MLP, the modulation linears,
ToRGB, the noise weights, the buffers). The batch is split over `data`.

The JAX package leaves the collectives to GSPMD. PyTorch's sharding
propagation does not shard a conv's out-channels, and the fused-activation
kernel is not a DTensor op, so the port writes the sharded forward out: each
rank keeps its slice of a sharded weight as the local shard of a DTensor
(`[Replicate(), Shard(dim)]` on the mesh), and each StyledConv computes its
own slice of the out-channels (the demodulation of a channel needs only that
channel's weights), adds the noise, runs `fused_leaky_relu` on the slice (the
CUDA kernel on a card) and all-gathers the channels over the `model`
sub-group before the next layer. The image is all-gathered over `data`, so
every rank returns the whole batch. Synthesis only, as in JAX: no backward.

A mesh is a `torch.distributed.DeviceMesh` over the ranks of an open process
group (`parallel.maybe_initialize_distributed`), rank r at (r // n_model,
r % n_model): gloo on the CPU, NCCL on cards, one process per device.
"""

from __future__ import annotations

import copy
import re
import warnings
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..device import resolve_device
from ..models import blocks  # a circular import (models.blocks imports parallel.mesh): read at call time
from ..ops.fused_act import fused_leaky_relu
from .mesh import DATA_AXIS

MODEL_AXIS = "model"

__all__ = ["MODEL_AXIS", "TensorParallelGenerator", "generator_param_shardings", "get_2d_mesh",
           "shard_generator_params"]

_STYLED = r"^(conv1|convs\.\d+)\."


def get_2d_mesh(n_data: int, n_model: int, devices: Any = None) -> DeviceMesh:
    """A (data x model) DeviceMesh over the n_data * n_model ranks of the open
    process group. `devices` names the device type: None takes `cuda`
    (RuntimeError without a card), "cpu" the CPU; a list of devices takes the
    type of its first."""
    if devices is not None and not isinstance(devices, (str, torch.device)):
        devices = list(devices)[0]
    device = resolve_device(devices)
    if not dist.is_initialized():
        raise ValueError("get_2d_mesh needs an open process group (parallel.maybe_initialize_distributed)")
    world = dist.get_world_size()
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} processes, the group has {world}")
    return DeviceMesh(device.type, torch.arange(world).reshape(n_data, n_model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def _shard_dim(name: str, shape: Sequence[int], n_model: int) -> Optional[int]:
    """The dim of a Generator tensor sharded over `model`, or None (replicated):
    a StyledConv's `conv.weight` [1, O, I, k, k] on O, its `activate.bias`
    [O], where O divides by n_model."""
    if re.match(_STYLED + r"conv\.weight$", name) and len(shape) == 5 and shape[1] % n_model == 0:
        return 1
    if re.match(_STYLED + r"activate\.bias$", name) and len(shape) == 1 and shape[0] % n_model == 0:
        return 0
    return None


def generator_param_shardings(generator: nn.Module, mesh: DeviceMesh) -> dict[str, tuple]:
    """{name: (data placement, model placement)} for every parameter and
    buffer of a Generator (the JAX package's `_spec_for`)."""
    n_model = mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))
    out = {}
    for name, t in list(generator.named_parameters()) + list(generator.named_buffers()):
        dim = _shard_dim(name, t.shape, n_model)
        out[name] = (Replicate(), Replicate() if dim is None else Shard(dim))
    return out


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] on each rank of `group` -> [size * n, ...] in group-rank order
    (x itself on a group of one)."""
    size = dist.get_world_size(group)
    if size == 1:
        return x
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    with warnings.catch_warnings():  # deprecated in favour of all_gather_single in newer PyTorch
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


class _ShardedStyledConv(nn.Module):
    """A StyledConv whose rank computes its slice of the out-channels and
    all-gathers them over the model group."""

    def __init__(self, conv: nn.Module, mesh: DeviceMesh):
        super().__init__()
        self.conv, self.noise, self.activate = conv.conv, conv.noise, conv.activate
        self.layer_id = conv.layer_id
        self.group = mesh.get_group(MODEL_AXIS)

    def forward(self, x, style, noise=None, bends=(), rng=None):
        weight = self.conv.weight.to_local()  # [1, O / n_model, I, k, k]
        out = self.noise(self.conv(x, style, weight=weight), noise, rng)
        out = fused_leaky_relu(out, self.activate.bias.to_local())
        n = dist.get_world_size(self.group)
        if n > 1:
            b, c, h, w = out.shape
            full = _all_gather(out, self.group)  # [n_model * b, c, h, w]
            out = full.reshape(n, b, c, h, w).transpose(0, 1).reshape(b, n * c, h, w)
        return blocks.apply_bends(out, self.layer_id, bends)


class TensorParallelGenerator(nn.Module):
    """A Generator sharded over a (data x model) mesh; `forward` takes
    `Generator.forward`'s arguments and returns what it returns, whole on
    every rank. Each rank synthesizes its block of the batch (the batch must
    divide by the data axis): the styles, per-sample noise, per-sample
    truncation are cut to the block. Bends see the block's rows.

    With `randomize_noise`, the noise maps that are not given are drawn for
    the whole batch before the synthesis, in the unsharded generator's order
    and dtype, from `rng` on every rank, and the first rank's draw is
    broadcast: every rank and every channel slice adds the same map to a
    sample, and the frames equal the unsharded generator's under an `rng` in
    the first rank's state, whatever the other ranks' states."""

    def __init__(self, generator: nn.Module, mesh: DeviceMesh):
        super().__init__()
        self.generator = generator
        self.mesh = mesh
        self.data_group = mesh.get_group(DATA_AXIS)

    def _block(self, x: Any, batch: int) -> Any:
        if not isinstance(x, torch.Tensor) or x.ndim == 0 or x.shape[0] != batch:
            return x
        n = self.mesh.size(0)
        return x.chunk(n)[self.mesh.get_local_rank(DATA_AXIS)]

    def _drawn_noise(self, noise: Optional[Sequence[Optional[torch.Tensor]]], batch: int,
                     rng: Optional[torch.Generator]) -> list:
        """`noise` with its missing maps drawn [batch, 1, H, W] and broadcast
        from the first rank of the mesh."""
        g = self.generator
        noise = list(noise) if noise is not None else []
        noise += [None] * (g.num_layers - len(noise))
        missing = [i for i, n in enumerate(noise) if n is None]
        if not missing:
            return noise
        buffers = [getattr(g.noises, f"noise_{i}") for i in missing]
        drawn = [torch.randn((batch, 1) + tuple(buf.shape[-2:]), generator=rng, device=buf.device, dtype=g.dtype)
                 for buf in buffers]
        if dist.get_world_size() > 1:
            flat = torch.cat([d.reshape(-1) for d in drawn])
            dist.broadcast(flat, src=int(self.mesh.mesh.reshape(-1)[0]))
            drawn = [t.view_as(d) for t, d in zip(flat.split([d.numel() for d in drawn]), drawn)]
        for i, d in zip(missing, drawn):
            noise[i] = d
        return noise

    def _gather(self, x: Any) -> Any:
        if isinstance(x, torch.Tensor):
            return _all_gather(x, self.data_group)
        if isinstance(x, list):
            return [self._gather(t) for t in x]
        return x

    @torch.no_grad()
    def forward(self, styles, return_latents: bool = False, return_activation_maps: bool = False,
                inject_index: Optional[int] = None, truncation: Any = 1.0, truncation_latent: Optional[torch.Tensor] = None,
                input_is_latent: bool = False, noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
                randomize_noise: bool = True, bends: Sequence[Any] = (), map_latents: bool = False,
                rng: Optional[torch.Generator] = None):
        first = styles if isinstance(styles, torch.Tensor) else styles[0]
        batch, n_data = first.shape[0], self.mesh.size(0)
        if batch % n_data:
            raise ValueError(f"a batch of {batch} does not split over a data axis of {n_data}")
        styles = self._block(styles, batch) if isinstance(styles, torch.Tensor) else [self._block(s, batch) for s in styles]
        if randomize_noise:
            noise = self._drawn_noise(noise, batch, rng)
        noise = None if noise is None else [self._block(n, batch) for n in noise]
        if not isinstance(truncation, (int, float)):
            truncation = torch.as_tensor(truncation)
            truncation = self._block(truncation.reshape(-1), batch) if truncation.numel() == batch else truncation
        out = self.generator(styles, return_latents, return_activation_maps, inject_index, truncation,
                             truncation_latent, input_is_latent, noise, randomize_noise, bends, map_latents, rng)
        if map_latents:
            return self._gather(out)
        return self._gather(out[0]), self._gather(out[1])


def shard_generator_params(generator: nn.Module, mesh: DeviceMesh) -> TensorParallelGenerator:
    """A TensorParallelGenerator over a copy of `generator` (on this rank's
    device) whose sharded tensors are DTensors holding this rank's slice;
    every rank must hold the same weights."""
    g = copy.deepcopy(generator).requires_grad_(False)
    shardings = generator_param_shardings(g, mesh)
    coord = mesh.get_local_rank(MODEL_AXIS)
    n_model = mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))
    for name, placements in shardings.items():
        if not isinstance(placements[1], Shard):
            continue
        path, _, leaf = name.rpartition(".")
        owner = g.get_submodule(path)
        local = getattr(owner, leaf).detach().chunk(n_model, dim=placements[1].dim)[coord].contiguous()
        setattr(owner, leaf, nn.Parameter(DTensor.from_local(local, mesh, placements, run_check=False),
                                          requires_grad=False))
    for name, module in list(g.named_modules()):
        if isinstance(module, blocks.StyledConv) and isinstance(shardings[f"{name}.conv.weight"][1], Shard):
            path, _, leaf = name.rpartition(".")
            setattr(g.get_submodule(path), leaf, _ShardedStyledConv(module, mesh))
    return TensorParallelGenerator(g, mesh)
