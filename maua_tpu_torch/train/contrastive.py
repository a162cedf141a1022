"""SimCLR / MoCo-style contrastive regularization on D's hidden layer
(counterpart of maua_tpu/train/contrastive.py).

InfoNCE and NT-Xent on projected features of D's last ResBlock, with queries
from the original images and keys from their augmented copies. The MoCo
options: a momentum key encoder (a frozen copy of D, moved towards D after
each D optimizer step), a bilinear key transform applied to the projected
keys (`bw` of the head, identity at init, trained with D's optimizer), and a
ring buffer of past projected keys used as extra InfoNCE negatives, whose
unfilled slots are masked out. The queue, its write pointer and its fill
count are device tensors, so the step never reads them on the host.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = [
    "ContrastiveState",
    "ProjectionHead",
    "contrastive_loss",
    "contrastive_loss_with_queue",
    "contrastive_regularizer_moco",
    "enqueue_keys",
    "init_contrastive_state",
    "momentum_update",
    "nt_xent_loss",
    "project",
]


def _nll_of_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.gather(F.log_softmax(logits, dim=-1), 1, labels[:, None])


def contrastive_loss(queries: torch.Tensor, keys: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """InfoNCE: the i-th query matches the i-th key."""
    logits = queries @ keys.t()
    logits = (logits - logits.max(dim=-1, keepdim=True).values.detach()) / temperature
    return _nll_of_labels(logits, torch.arange(queries.shape[0], device=logits.device)).mean()


def nt_xent_loss(queries: torch.Tensor, keys: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """NT-Xent over the 2b x 2b similarity matrix with the diagonal masked."""
    b = queries.shape[0]
    projs = torch.cat([queries, keys])
    logits = projs @ projs.t()
    mask = torch.eye(2 * b, dtype=torch.bool, device=logits.device)
    logits = torch.where(mask, torch.finfo(logits.dtype).min, logits) / temperature
    idx = torch.arange(b, device=logits.device)
    labels = torch.cat([idx + b, idx])  # the positive of sample i is i + b, and back
    return _nll_of_labels(logits, labels).sum() / (2 * (b - 1))


class ProjectionHead(nn.Module):
    """The SimCLR projector, a 2-layer MLP: `w1` [feat, hidden], `b1`, `w2`
    [hidden, out], `b2`, and with `bilinear` the key transform `bw` [out,
    out], identity at init. Weights N(0, 1) / sqrt(fan_in) from `generator`
    (the JAX package's init)."""

    def __init__(self, feat_dim: int, hidden: int = 256, out: int = 128, bilinear: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w1 = nn.Parameter(torch.randn(feat_dim, hidden, generator=generator) / math.sqrt(feat_dim))
        self.b1 = nn.Parameter(torch.zeros(hidden))
        self.w2 = nn.Parameter(torch.randn(hidden, out, generator=generator) / math.sqrt(hidden))
        self.b2 = nn.Parameter(torch.zeros(out))
        self.bw = nn.Parameter(torch.eye(out)) if bilinear else None

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return project(self, feats)


def project(head: ProjectionHead, feats: torch.Tensor) -> torch.Tensor:
    """Flatten, MLP with ReLU, L2-normalise with a 1e-8 floor on the norm."""
    h = feats.reshape(feats.shape[0], -1).float()
    h = torch.relu(h @ head.w1 + head.b1)
    h = h @ head.w2 + head.b2
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=1, keepdim=True), min=1e-8)


class ContrastiveState(NamedTuple):
    """key_d: the momentum key encoder (a frozen copy of D), or None.
    queue [Q, out] fp32 ring buffer of past projected keys, queue_ptr the
    write cursor and queue_filled the number of real keys in it (0-d int64
    tensors), or all None without a queue."""

    key_d: Optional[nn.Module] = None
    queue: Optional[torch.Tensor] = None
    queue_ptr: Optional[torch.Tensor] = None
    queue_filled: Optional[torch.Tensor] = None


def init_contrastive_state(d: Optional[nn.Module], use_momentum: bool, queue_size: int, out_dim: int = 128,
                           device=None) -> Optional[ContrastiveState]:
    """The state for the options asked for, or None for plain SimCLR."""
    if not use_momentum and queue_size <= 0:
        return None
    key_d = copy.deepcopy(d).requires_grad_(False) if use_momentum else None
    if queue_size <= 0:
        return ContrastiveState(key_d)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return ContrastiveState(key_d, torch.zeros((queue_size, out_dim), device=device), zero, zero.clone())


@torch.no_grad()
def momentum_update(cl_state: Optional[ContrastiveState], d: nn.Module, beta: float) -> None:
    """key = key * beta + (1 - beta) * D, in place, after a D optimizer step."""
    if cl_state is None or cl_state.key_d is None:
        return
    for k, p in zip(cl_state.key_d.parameters(), d.parameters()):
        k.copy_(k * beta + (1.0 - beta) * p)


def enqueue_keys(cl_state: Optional[ContrastiveState], keys: torch.Tensor) -> Optional[ContrastiveState]:
    """The state with a batch of projected keys written at the cursor. The
    queue's length is a multiple of the batch (checked when the state is
    built), so a write never wraps."""
    if cl_state is None or cl_state.queue is None:
        return cl_state
    q, n = cl_state.queue.shape[0], keys.shape[0]
    rows = (cl_state.queue_ptr + torch.arange(n, device=keys.device)) % q
    queue = cl_state.queue.index_copy(0, rows, keys.detach().to(cl_state.queue.dtype))
    return cl_state._replace(queue=queue, queue_ptr=(cl_state.queue_ptr + n) % q,
                             queue_filled=torch.clamp(cl_state.queue_filled + n, max=q))


def contrastive_loss_with_queue(queries: torch.Tensor, keys: torch.Tensor, queue: torch.Tensor,
                                queue_filled: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """InfoNCE with the queue's keys as extra negatives: logits = q @ [keys;
    queue]^T, positives on the diagonal of the keys block; unfilled queue
    slots get the dtype's most negative value."""
    b = queries.shape[0]
    logits = queries @ torch.cat([keys, queue.to(keys.dtype)]).t()
    slot = torch.arange(queue.shape[0], device=logits.device)
    neg = torch.where(slot < queue_filled, 0.0, torch.finfo(logits.dtype).min).to(logits.dtype)
    logits = torch.cat([logits[:, :b], logits[:, b:] + neg], dim=1)
    logits = (logits - logits.max(dim=-1, keepdim=True).values.detach()) / temperature
    return _nll_of_labels(logits, torch.arange(b, device=logits.device)).mean()


def contrastive_regularizer_moco(
    d_hidden: Callable[[torch.Tensor], torch.Tensor],
    key_d_hidden: Optional[Callable[[torch.Tensor], torch.Tensor]],
    head: ProjectionHead,
    cl_state: Optional[ContrastiveState],
    originals: Sequence[torch.Tensor],
    augmenteds: Sequence[torch.Tensor],
    loss_type: str = "infonce",
    temperature: float = 0.1,
) -> tuple[torch.Tensor, Optional[ContrastiveState]]:
    """Queries: D's hidden layer of the originals through the head. Keys: the
    key encoder's (without gradient) or D's of the augmented images through
    the head, then the bilinear transform. The loss against the current keys
    (and the queue's, for InfoNCE with a queue); the new keys are enqueued.
    Returns (loss, state)."""
    queries = torch.cat([project(head, d_hidden(x)) for x in originals])
    if key_d_hidden is not None:
        with torch.no_grad():
            keys = torch.cat([project(head, key_d_hidden(x)) for x in augmenteds])
    else:
        keys = torch.cat([project(head, d_hidden(x)) for x in augmenteds])
    if head.bw is not None:
        keys = keys @ head.bw.t()
    if cl_state is not None and cl_state.queue is not None and loss_type != "nt_xent":
        loss = contrastive_loss_with_queue(queries, keys, cl_state.queue, cl_state.queue_filled, temperature)
        cl_state = enqueue_keys(cl_state, keys)
    elif loss_type == "nt_xent":
        loss = nt_xent_loss(queries, keys, temperature)
    else:
        loss = contrastive_loss(queries, keys, temperature)
    return loss, cl_state
