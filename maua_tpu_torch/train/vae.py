"""VAE training and hyperparameter-sweep scoring (counterpart of
maua_tpu/train/vae.py; the reference's accelerate/accelerate_logcosh.py).

`train_vae` trains any model of models/autoencoder.py in place with Adam at
optax's defaults (b1 0.9, b2 0.999, eps 1e-8), batch norm in training mode
(batch statistics, running statistics updated), and the reparameterisation's
normal draws from a `draws` object (`Draws(0)` on the model's device unless
given), one [B, model.code_dim] draw per step, so a test can replay the JAX
package's. Like the JAX trainer it takes one batch before the first step (the
batch flax initialises from), so both train on the same batches of a data
iterator, and logs every `log_every` steps from step 0. The forward and
backward hold TF32 off.

`sweep_trial` halves the batch on an out-of-memory error and returns
`FAILURE_SCORE` when training diverges or no batch fits.
`make_perceptual_loss` is eval/lpips.py's.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..draws import Draws
from ..eval.lpips import make_perceptual_loss
from ..models.autoencoder import vae_loss
from ..models.blocks import tf32

__all__ = ["FAILURE_SCORE", "make_perceptual_loss", "sweep_trial", "train_vae"]

FAILURE_SCORE = 27_000.0  # the sweep's sentinel (reference: accelerate_logcosh.py:221)


def train_vae(
    model: torch.nn.Module,
    data_iter,
    n_steps: int = 1000,
    lr: float = 1e-3,
    perceptual_weight: float = 0.0,
    perceptual_loss: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    kld_weight: float = 1.0,
    draws=None,
    log_every: int = 50,
    on_log: Optional[Callable[[dict], None]] = None,
):
    """Train `model` (on its device) on batches [B, C, H, W] from `data_iter`;
    returns (model.state_dict(), history). The loss is `model.loss` where the
    model has one (LogCoshVAE), else `vae_loss` with `kld_weight`."""
    device = next(model.parameters()).device
    draws = draws if draws is not None else Draws(0, device)
    x0 = torch.as_tensor(next(data_iter), device=device)
    if x0.ndim != 4:
        raise ValueError(f"train_vae takes [B, C, H, W] batches, got {tuple(x0.shape)}")
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    loss_fn_model = getattr(model, "loss", None)

    history = []
    t0 = time.time()
    for i in range(n_steps):
        x = torch.as_tensor(next(data_iter), device=device)
        eps = draws.normal(x.shape[0], model.code_dim)
        with tf32(conv=False, matmul=False):
            recon, mu, log_var = model(x, eps=eps)
            if loss_fn_model is not None:
                losses = loss_fn_model(x, recon, mu, log_var)
            else:
                losses = vae_loss(x, recon, mu, log_var, kld_weight)
            total = losses["Total"]
            if perceptual_weight > 0 and perceptual_loss is not None:
                losses["Perceptual"] = perceptual_loss(recon, x)
                total = total + perceptual_weight * losses["Perceptual"]
            losses["Total"] = total
            opt.zero_grad(set_to_none=True)
            total.backward()
        opt.step()
        if i % log_every == 0:
            entry = {k: float(v.detach()) for k, v in losses.items()}
            entry.update({"step": i, "elapsed": time.time() - t0})
            history.append(entry)
            if on_log:
                on_log(entry)
            if not np.isfinite(entry["Total"]):
                break
    return model.state_dict(), history


def _out_of_memory(e: RuntimeError) -> bool:
    return isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e).lower()


def sweep_trial(
    model_fn: Callable[[], Any],
    data_fn: Callable[[int], Any],
    batch_size: int = 32,
    min_batch: int = 1,
    **train_kwargs,
) -> tuple[float, Any]:
    """One sweep trial (reference: accelerate_logcosh.py:215-229): train a
    fresh model_fn() on data_fn(batch_size); on an out-of-memory error halve
    the batch and try again. Returns (the last logged Total, the state dict),
    or (FAILURE_SCORE, None) when it diverges or no batch down to min_batch
    fits."""
    while batch_size >= min_batch:
        try:
            model = model_fn()
            state, history = train_vae(model, data_fn(batch_size), **train_kwargs)
            if not history or not np.isfinite(history[-1]["Total"]):
                return FAILURE_SCORE, None
            return history[-1]["Total"], state
        except RuntimeError as e:
            if not _out_of_memory(e):
                raise
            model = None
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            batch_size //= 2
    return FAILURE_SCORE, None
