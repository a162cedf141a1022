"""Model-rewriting demo, in torch for the port (counterpart of
examples/rewrite_demo.py): a kick-onset envelope scales a fixed random
direction added to the first StyledConv's 3x3 weight.

A rewrite is a `(weight, modulation[B]) -> weight` function applied to the
ORIGINAL weight for each batch (reference render.py:122-127), so silence
means an unmodified model and the perturbation never accumulates. Here the
weight is named by its state-dict key, `conv1.conv.weight` ([1, O, I, 3, 3]),
and `render()` feeds the rewritten tensor through `torch.func.functional_call`.

Run:  python -m maua_tpu_torch.pipeline.cli --ckpt g.pt --audio_file track.wav \\
          --audioreactive_file maua_tpu_torch/examples/rewrite_demo.py

The direction comes from `draw_direction`, from a `torch.Generator` seeded
with 42 (the JAX example's `PRNGKey(42)`), so a test can hand in JAX's draw.
"""

import torch

import maua_tpu_torch.audio as ar
from maua_tpu_torch.reactive import Rewrite, slerp_loops


def initialize(args):
    args.kick_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmax=150, smooth=5, clip=95, power=2)
    return args


def get_latents(selection, args):
    latents = slerp_loops(ar.as_tensor(selection), args.n_frames, n_loops=max(1, int(args.duration // 8)))
    return ar.gaussian_filter(latents, 2)


def draw_direction(shape, dtype, device):
    """The fixed unit normal direction in weight space."""
    gen = torch.Generator(device=device).manual_seed(42)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def get_rewrites(args):
    # the onset envelope's mean over the batch sets how far along the
    # direction the batch's weight sits (the weight has no frame axis): the
    # texture shudders on kicks and relaxes to the trained model between them
    def perturb(weight, mod):
        direction = draw_direction(weight.shape, weight.dtype, weight.device)
        strength = torch.mean(mod) * 0.4 * torch.std(weight, correction=0)
        return weight + strength * direction

    return [Rewrite("conv1.conv.weight", perturb, modulation=args.kick_onsets)]
