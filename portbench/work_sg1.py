"""FLOPs and bytes that StyleGAN1's synthesis needs, from a configuration's
shapes (`size`, `channels`, `style_dim`) and the output resolution from which
the reference fuses the up-conv (`reference.stylegan1.FUSED_FROM`).

Nothing here looks at the program, so the counts read the same whatever
implements the work. A FLOP is a multiply or an add: 2 per MAC. Per frame,
synthesis from W+ (the mapping network does not run), in MACs:
* the 4^2 block's 3x3 conv, and each block's conv1 at its output r x r;
* each block's up-conv: below `fused_from` a 3x3 conv at the output
  resolution (r^2 x in x out x 9), from it the stride-2 transposed conv of the
  4x4 summed weight ((r/2)^2 x in x out x 16, every tap meeting an input);
* the [1, 2, 1] blur after each up-conv: 9 taps an output, per channel;
* each epilogue's style linear (style_dim x 2 x channels, 2 a block);
* torgb's 1x1 conv.
Noise, bias, activation, instance norm and the style's scale and shift are
elementwise and not counted.

Bytes: each blur site reads its fp32 input and writes its fp32 output once,
both [channels, r, r] a frame.
"""

from __future__ import annotations

from portbench.reference.stylegan1 import FUSED_FROM

F32 = 4


def blocks(config: dict) -> list[tuple[int, int, int]]:
    """(resolution, input channels, channels) of each block, 4^2 first."""
    ch = config["channels"]
    return [(4 * 2**i, ch[max(i - 1, 0)], c) for i, c in enumerate(ch)]


def blur_sites(config: dict) -> list[tuple[int, int]]:
    """(resolution, channels) of each up-conv's blur: every block but 4^2."""
    return [(r, c) for r, _, c in blocks(config)[1:]]


def frame_macs(config: dict, fused_from: int = FUSED_FROM) -> int:
    style = config["style_dim"]
    macs = 0
    for r, cin, c in blocks(config):
        if r == 4:
            macs += 16 * c * c * 9
        elif r < fused_from:
            macs += r * r * cin * c * 9
        else:
            macs += (r // 2) ** 2 * cin * c * 16
        if r > 4:
            macs += r * r * c * 9 + r * r * c * c * 9  # blur, conv1
        macs += 2 * style * 2 * c  # the two epilogues' style linears
    return macs + config["size"] ** 2 * config["channels"][-1] * 3  # torgb


def frame_flops(config: dict, fused_from: int = FUSED_FROM) -> int:
    """One frame of synthesis from W+."""
    return 2 * frame_macs(config, fused_from)


def blur_bytes(config: dict) -> int:
    """Bytes the blur sites need for one frame: fp32 input read, output written."""
    return sum(2 * c * r * r * F32 for r, c in blur_sites(config))
