"""The FLOP and byte counts: against a hand count at a tiny configuration,
and unchanged when reg_chunks or remat change how the program launches the
same work."""

from __future__ import annotations

import math

import pytest

from portbench import bytes as work_bytes
from portbench import flops

TINY = {"size": 8, "style_dim": 4, "n_mlp": 2, "channel_multiplier": 1, "channel_max": 2}


def test_synthesis_by_hand():
    # channels 2 everywhere; S = 4. conv1 at 4^2: mod 2*4 + demod 2*2 + conv 16*2*2*9; to_rgb1: mod 8 + 16*2*3
    conv1 = 8 + 4 + 576
    rgb1 = 8 + 96
    # res 8: up conv from 4^2 (mod 8, demod 4, 16*2*2*9 = 576, blur 64*2*16 = 2048), conv (8 + 4 + 64*2*2*9),
    # to_rgb (8 + 64*2*3) + skip upsample 64*3*4
    res8 = (8 + 4 + 576 + 2048) + (8 + 4 + 2304) + (8 + 384 + 768)
    assert flops.synthesis_macs(flops.shapes_of(TINY)) == conv1 + rgb1 + res8
    assert flops.render_frame_flops(TINY) == 2 * (conv1 + rgb1 + res8)


def test_discriminator_by_hand():
    # from_rgb 64*3*2; block at 8: conv1 64*2*2*9, blur 81*2*16 + conv2 16*2*2*9, skip blur 49*2*16 + 16*2*2;
    # final_conv 16*3*2*9, final_linear 16*2*2 + 2
    by_hand = 384 + 2304 + 2592 + 576 + 1568 + 64 + 864 + 64 + 2
    assert flops.disc_macs(flops.shapes_of(TINY)) == by_hand


def test_train_step_by_hand():
    s = flops.shapes_of(TINY)
    fm, fg, fd, fd0 = flops.mapping_macs(s), flops.synthesis_macs(s), flops.disc_macs(s), flops.from_rgb_macs(s)
    assert fm == 2 * 4 * 4
    b = 4
    plain = b * (2 * fm + fg) + 2 * b * fd + 2 * b * (2 * fd - fd0) + b * (2 * fm + fg) + 2 * b * fd \
        + 2 * b * (fg + 2 * fm)
    assert flops.train_step_flops(TINY, b, 1) == 2 * plain
    assert flops.train_step_flops(TINY, b, 4) == 2 * (plain + 2 * (6 * fg + 6 * fm))
    assert flops.train_step_flops(TINY, b, 0) == 2 * (plain + 6 * b * fd + 2 * (6 * fg + 6 * fm))


def test_bias_act_sites_by_hand():
    s = flops.shapes_of(TINY)
    assert work_bytes.layer_sites(s) == [(32, 2), (128, 2), (128, 2)]
    assert work_bytes.disc_sites(s) == [(128, 2), (128, 2), (32, 2), (32, 2), (2, 2)]
    assert work_bytes.render_batch_bytes(TINY, 3) == sum(2 * 3 * e * 4 + c * 4 for e, c in work_bytes.layer_sites(s))
    fwd, grad = work_bytes.train_step_bytes(TINY, 4, 1)
    synth = [(4, 4)] * 4 + work_bytes.layer_sites(s)
    disc = work_bytes.disc_sites(s)
    assert fwd == work_bytes.forward_bytes(synth, 4) * 2 + work_bytes.forward_bytes(disc, 8) \
        + work_bytes.forward_bytes(disc, 4)
    assert grad == work_bytes.grad_bytes(disc, 8) + work_bytes.grad_bytes(disc, 4) + work_bytes.grad_bytes(synth, 4)


@pytest.mark.parametrize("size", [256, 1024])
def test_counts_do_not_follow_chunks_or_remat(size):
    """The training work counted for the same steps under configs that differ only in
    reg_chunks and remat_synth (what the CLI resolves at 1024^2 and what it
    would without its automatic rule)."""
    from maua_tpu_torch.train import make_train_config

    from portbench.drivers import train as drv

    conf = dict(TINY, size=size, style_dim=512, n_mlp=8, channel_multiplier=2, channel_max=512)

    class Fake:
        def __init__(self, cfg):
            self.cfg, self.steps, self.window_peak = cfg, list(range(5, 40)), 1
            self.cell = type("C", (), {"config": conf})()

    works = [drv.work(Fake(make_train_config(size=size, batch_size=12, reg_chunks=k, remat_synth=r)))
             for k, r in ((1, False), (3, True), (3, False), (1, True))]
    assert all(w == works[0] for w in works)
    assert works[0]["flops"] > 0 and works[0]["fused_bias_act_grad_bytes"] > 0


def test_published_frame_is_about_150_gflop():
    conf = {"size": 1024, "style_dim": 512, "n_mlp": 8, "channel_multiplier": 2, "channel_max": 512}
    assert math.isclose(flops.render_frame_flops(conf) / 1e9, 150.67, rel_tol=1e-3)
