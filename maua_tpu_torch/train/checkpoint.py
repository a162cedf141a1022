"""Checkpoint save / resume (counterpart of maua_tpu/train/checkpoint.py).

The port's checkpoint is one `torch.save` file, `<dir>/step_<step:07d>.pt`,
laid out as a rosinality training checkpoint ({g, d, g_ema, g_optim,
d_optim}, state dicts with rosinality keys) plus the rest of the state
(step, lookahead cache, running path-length mean, ADA's p and sign counts,
the contrastive projection head and its MoCo state). Its `g_ema`
therefore loads with `maua_tpu_torch.io.load_generator`, which feeds the
render path. `load_torch_training_checkpoint` resumes from a reference
`{g, d, g_ema}` `.pt`.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

from ..io.torch_ckpt import load_torch_checkpoint
from .lookahead import lookahead_minimax_init
from .step import TrainState

__all__ = ["latest_checkpoint", "load_torch_training_checkpoint", "restore_checkpoint", "save_checkpoint"]

_FORMAT = "maua_tpu_torch.train"
_NAME = re.compile(r"step_(\d+)\.pt")


def save_checkpoint(ckpt_dir: str, state: TrainState, step: Optional[int] = None, keep: int = 5) -> str:
    """Write the full train state; keep the newest `keep` checkpoints of the
    directory. Returns the file's path."""
    step = state.step if step is None else int(step)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:07d}.pt"))
    la = state.lookahead
    payload = {
        "format": _FORMAT,
        "step": state.step,
        "g": state.g.state_dict(),
        "d": state.d.state_dict(),
        "g_ema": state.g_ema.state_dict(),
        "g_optim": state.g_optim.state_dict(),
        "d_optim": state.d_optim.state_dict(),
        "lookahead": None if la is None else {"slow_g": la.slow_g, "slow_d": la.slow_d, "step": la.step},
        "mean_path_length": state.mean_path_length,
        "ada_p": state.ada_p,
        "ada_signs": state.ada_signs,
        "ada_n": state.ada_n,
        "cl_head": None if state.cl_head is None else state.cl_head.state_dict(),
        "cl_state": None if state.cl_state is None else _cl_state_payload(state.cl_state),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in sorted(f for f in os.listdir(ckpt_dir) if _NAME.fullmatch(f))[:-keep]:
        os.remove(os.path.join(ckpt_dir, old))
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest `step_*.pt` of the directory, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = sorted(f for f in os.listdir(ckpt_dir) if _NAME.fullmatch(f))
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


def is_port_checkpoint(ckpt: Any) -> bool:
    return isinstance(ckpt, dict) and ckpt.get("format") == _FORMAT


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint written by `save_checkpoint` into `state` (from
    `init_train_state` with the same config) and return it."""
    ckpt = torch.load(path, map_location=state.device, weights_only=False)
    if not is_port_checkpoint(ckpt):
        raise ValueError(f"{path}: not a maua_tpu_torch training checkpoint (use load_torch_training_checkpoint)")
    state.g.load_state_dict(ckpt["g"])
    state.d.load_state_dict(ckpt["d"])
    state.g_ema.load_state_dict(ckpt["g_ema"])
    state.g_optim.load_state_dict(ckpt["g_optim"])
    state.d_optim.load_state_dict(ckpt["d_optim"])
    if ckpt["lookahead"] is not None and state.lookahead is not None:
        la = ckpt["lookahead"]
        state.lookahead.slow_g, state.lookahead.slow_d, state.lookahead.step = la["slow_g"], la["slow_d"], la["step"]
    state.mean_path_length = ckpt["mean_path_length"].to(state.device)
    # a checkpoint written before ADA was ported holds p as a float and no counts
    state.ada_p = torch.as_tensor(ckpt["ada_p"], dtype=torch.float32).to(state.device)
    for name in ("ada_signs", "ada_n"):
        setattr(state, name, torch.as_tensor(ckpt.get(name, 0.0), dtype=torch.float32).to(state.device))
    if (ckpt.get("cl_head") is None) != (state.cl_head is None):
        raise ValueError(f"{path}: the checkpoint's contrastive head does not match the config's")
    if state.cl_head is not None:
        state.cl_head.load_state_dict(ckpt["cl_head"])
    if state.cl_state is not None:
        cl = ckpt.get("cl_state") or {}
        if state.cl_state.key_d is not None:
            state.cl_state.key_d.load_state_dict(cl["key_d"])
        if state.cl_state.queue is not None:
            state.cl_state = state.cl_state._replace(queue=cl["queue"], queue_ptr=cl["queue_ptr"],
                                                     queue_filled=cl["queue_filled"])
    state.step = int(ckpt["step"])
    return state


def _cl_state_payload(cl) -> dict[str, Any]:
    return {"key_d": None if cl.key_d is None else cl.key_d.state_dict(), "queue": cl.queue,
            "queue_ptr": cl.queue_ptr, "queue_filled": cl.queue_filled}


def _with_kernels(module: torch.nn.Module, sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """`sd` with the FIR kernel buffers it lacks taken from `module`."""
    sd = dict(sd)
    for name, buf in module.state_dict().items():
        if name.endswith(".kernel") and name not in sd:
            sd[name] = buf
    return sd


@torch.no_grad()
def load_torch_training_checkpoint(path: str, state: TrainState, transfer_mapping_only: bool = False) -> TrainState:
    """Resume from a rosinality-format `{g, d, g_ema}` `.pt`. Optimizer moments
    are not carried over (Adam restarts). `transfer_mapping_only` loads only
    the mapping network (`style.*`) of g and g_ema. Otherwise g, d and g_ema
    are loaded whole, the lookahead cache restarts from the loaded weights,
    and the step is taken from the first number in the file's name."""
    ckpt = load_torch_checkpoint(path)
    if transfer_mapping_only:
        for key, module in (("g", state.g), ("g_ema", state.g_ema)):
            if key in ckpt:
                style = {k: v for k, v in ckpt[key].items() if k.startswith("style.")}
                module.load_state_dict({**module.state_dict(), **style})
        return state
    for key, module in (("g", state.g), ("d", state.d), ("g_ema", state.g_ema)):
        if key in ckpt:
            module.load_state_dict(_with_kernels(module, ckpt[key]))
    if state.lookahead is not None:
        state.lookahead = lookahead_minimax_init(state.g.parameters(), state.d.parameters())
    m = re.search(r"(\d+)", os.path.basename(path))
    if m:
        state.step = int(m.group(1))
    return state
