"""FLOPs that StyleGAN2's algorithm needs, from a configuration's shapes.

Nothing here looks at the program: the counts follow from the configuration
(size, style_dim, n_mlp, channel_multiplier, channel_max) and the step's
schedule, so they read the same whatever implements the work (chunked or
not, rematerialised or not). A FLOP is a multiply or an add: 2 per MAC.

Per sample, in MACs:
* mapping, per z: n_mlp x style_dim^2;
* synthesis from W+ (`synthesis_macs`): each styled conv's modulation
  (style_dim x in) and demodulation (in x out), its 3x3 conv at the output
  resolution (the up convs: a stride-2 transposed 3x3 conv, r^2 x in x out x
  9 for an r x r input, and the 4x4 blur of its (2r+1)^2 output down to
  (2r)^2), each ToRGB's modulation, its 1x1 conv and the skip's 2x FIR
  upsample (4 of the 16 taps meet a non-zero sample);
* discriminator (`disc_macs`): from_rgb, per ResBlock the 3x3 conv, the blur
  and stride-2 3x3 conv, the skip's blur and stride-2 1x1 conv, then
  final_conv and both final linears. Elementwise work (bias, activation,
  noise, minibatch stddev) is not counted.

A training step (`train_step_flops`) counts, as multiples of a forward:
backward = wgrad + dgrad (2x), a forward-only pass 1x; R1 and the path
penalty 6x (forward, the create_graph backward, and the double backward
through both graphs, 4x). Fakes in the D phase come from a synthesis without
gradient; D's input gradient is not needed there. The G phase's backward
goes through D for its input gradient only. The path penalty runs on
batch // path_batch_shrink samples, its mapping network 3x. Remat's
recomputed synthesis and the chunking of R1 and the path penalty are not in
the count: they change how the same work is launched.
"""

from __future__ import annotations

import math
from typing import NamedTuple


class Shapes(NamedTuple):
    size: int
    style_dim: int = 512
    n_mlp: int = 8
    channel_multiplier: int = 2
    channel_max: int = 512


def shapes_of(config: dict) -> Shapes:
    return Shapes(*(config[k] for k in ("size", "style_dim", "n_mlp", "channel_multiplier", "channel_max")))


def channels(s: Shapes) -> dict[int, int]:
    table = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * s.channel_multiplier, 128: 128 * s.channel_multiplier,
             256: 64 * s.channel_multiplier, 512: 32 * s.channel_multiplier, 1024: 16 * s.channel_multiplier}
    return {k: min(v, s.channel_max) for k, v in table.items()}


def resolutions(s: Shapes) -> list[int]:
    return [2**i for i in range(3, int(math.log2(s.size)) + 1)]


def mapping_macs(s: Shapes) -> int:
    """One z through the mapping network."""
    return s.n_mlp * s.style_dim * s.style_dim


def synthesis_macs(s: Shapes) -> int:
    ch, S = channels(s), s.style_dim
    c4 = ch[4]
    macs = c4 * S + c4 * c4 + 16 * c4 * c4 * 9  # conv1 at 4^2: modulation, demodulation, conv
    macs += c4 * S + 16 * c4 * 3  # to_rgb1: modulation, 1x1 conv
    prev = c4
    for r in resolutions(s):
        c = ch[r]
        half = r // 2
        macs += prev * S + prev * c + half * half * prev * c * 9 + r * r * c * 16  # up conv + its blur
        macs += c * S + c * c + r * r * c * c * 9  # second conv
        macs += c * S + r * r * c * 3 + r * r * 3 * 4  # ToRGB + the skip's upsample
        prev = c
    return macs


def from_rgb_macs(s: Shapes) -> int:
    return s.size * s.size * 3 * channels(s)[s.size]


def disc_macs(s: Shapes) -> int:
    ch = channels(s)
    macs = from_rgb_macs(s)
    r = s.size
    while r > 4:
        c, c2, half = ch[r], ch[r // 2], r // 2
        macs += r * r * c * c * 9  # conv1
        macs += (r + 1) * (r + 1) * c * 16 + half * half * c * c2 * 9  # blur + stride-2 conv2
        macs += (r - 1) * (r - 1) * c * 16 + half * half * c * c2  # skip: blur + stride-2 1x1 conv
        r = half
    c4 = ch[4]
    macs += 16 * (c4 + 1) * c4 * 9 + 16 * c4 * c4 + c4  # final_conv, final_linear
    return macs


def render_frame_flops(config: dict) -> int:
    """One frame of synthesis from W+ (the mapping network does not run)."""
    return 2 * synthesis_macs(shapes_of(config))


def r1_due(step: int, d_reg_every: int) -> bool:
    return step % d_reg_every == 0


def path_due(step: int, g_reg_every: int) -> bool:
    return step % g_reg_every == 0


def train_step_flops(config: dict, batch: int, step: int, d_reg_every: int = 16, g_reg_every: int = 4,
                     path_batch_shrink: int = 2) -> int:
    """FLOPs of training step `step` (R1 every d_reg_every, the path penalty
    every g_reg_every)."""
    s = shapes_of(config)
    fm, fg, fd, fd0 = mapping_macs(s), synthesis_macs(s), disc_macs(s), from_rgb_macs(s)
    macs = batch * (2 * fm + fg) + 2 * batch * fd + 2 * batch * (fd + fd - fd0)  # D phase
    macs += batch * (2 * fm + fg) + batch * fd + batch * fd + 2 * batch * (fg + 2 * fm)  # G phase
    if r1_due(step, d_reg_every):
        macs += 6 * batch * fd
    if path_due(step, g_reg_every):
        pb = max(1, batch // path_batch_shrink)
        macs += pb * (6 * fg + 3 * 2 * fm)
    return 2 * macs
