"""Bytes that the bias + leaky-ReLU sites of a configuration need.

A site is a place in the model where a bias-add + scaled leaky-ReLU runs:
each styled conv's activation (n_layers of them, one at 4^2 and two at each
resolution above), each mapping layer (n_mlp per z), and in the
discriminator from_rgb, both convs of each ResBlock, final_conv and the first
final linear. The forward reads its input and the bias once and writes its
output once; the gradient reads dy and the saved output once and writes dx
once. Counts come from the configuration's shapes and the step's schedule,
never from the program's launches, so they read the same whatever
implements the sites (chunked or rematerialised launches of the same work
are not counted twice).

Passes a training step needs through the sites (as the step's algorithm
does): forward: G (mapping for z1 and z2, synthesis) and D in the D phase (D
on 2B), again in the G phase (D on B), D in R1 (B), G in the path penalty
(B // 2); gradient: D in the D phase (2B), D and G in the G phase, D three
times in R1 (the create_graph backward, the tangent and the forward node
reached again by the double backward) and, in the path penalty, the styled
convs three times and the mapping network once per z.
"""

from __future__ import annotations

from .flops import Shapes, channels, resolutions, shapes_of

F32 = 4


def layer_sites(s: Shapes) -> list[tuple[int, int]]:
    """(elements per sample, channels) of each styled conv's activation."""
    ch = channels(s)
    sites = [(ch[4] * 16, ch[4])]
    for r in resolutions(s):
        sites += [(ch[r] * r * r, ch[r])] * 2
    return sites


def mapping_sites(s: Shapes) -> list[tuple[int, int]]:
    return [(s.style_dim, s.style_dim)] * s.n_mlp


def disc_sites(s: Shapes) -> list[tuple[int, int]]:
    ch = channels(s)
    sites = [(ch[s.size] * s.size * s.size, ch[s.size])]
    r = s.size
    while r > 4:
        sites += [(ch[r] * r * r, ch[r]), (ch[r // 2] * (r // 2) ** 2, ch[r // 2])]
        r //= 2
    return sites + [(ch[4] * 16, ch[4]), (ch[4], ch[4])]


def forward_bytes(sites, n: int, dt: int = F32) -> int:
    """One forward pass of n samples through `sites`: x read, bias read, y written."""
    return sum(2 * n * e * dt + c * F32 for e, c in sites)


def grad_bytes(sites, n: int, dt: int = F32) -> int:
    """One gradient pass of n samples through `sites`: dy and y read, dx written."""
    return sum(3 * n * e * dt for e, _ in sites)


def render_batch_bytes(config: dict, batch: int) -> int:
    """Forward bytes of one batch of synthesis from W+."""
    return forward_bytes(layer_sites(shapes_of(config)), batch)


def train_step_bytes(config: dict, batch: int, step: int, d_reg_every: int = 16, g_reg_every: int = 4,
                     path_batch_shrink: int = 2) -> tuple[int, int]:
    """(forward bytes, gradient bytes) of training step `step`."""
    s = shapes_of(config)
    synth = mapping_sites(s) * 2 + layer_sites(s)  # z1 and z2 mapped, then the synthesis
    disc = disc_sites(s)
    fwd = forward_bytes(synth, batch) + forward_bytes(disc, 2 * batch)  # D phase
    fwd += forward_bytes(synth, batch) + forward_bytes(disc, batch)  # G phase
    grad = grad_bytes(disc, 2 * batch) + grad_bytes(disc, batch) + grad_bytes(synth, batch)
    if step % d_reg_every == 0:
        fwd += forward_bytes(disc, batch)
        grad += 3 * grad_bytes(disc, batch)
    if step % g_reg_every == 0:
        pb = max(1, batch // path_batch_shrink)
        fwd += forward_bytes(synth, pb)
        grad += 3 * grad_bytes(layer_sites(s), pb) + grad_bytes(mapping_sites(s) * 2, pb)
    return fwd, grad
