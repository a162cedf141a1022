"""Rendering cells of StyleGAN1: repeated calls of
`maua_tpu_torch.render.render` on seeded clips, with the generator the port
builds from a G_style checkpoint, each frame handed to the harness's frame
sink in place of the video encoder.

Set-up makes the weights on the device from the seed (the configuration's
`assumed` scales), writes them as a G_style checkpoint, stored noise maps
included, and builds the program's StyleGAN1 from it through
`load_stylegan1`, the port's normal path. The mean latent's z, the clips
(W+ between keyframes from the reference mapping network, per-frame noise on
the blocks no wider than `noise_max_width`, the other blocks taking the
stored maps, and a constant truncation timeline), the warm-up call, the
window, the sink and the comparison of uint8 levels are those of
`drivers/render.py`. The reference is `reference/stylegan1.py`, in blocks of
8 frames; the judge also reports, on standard error, the share of the judged
frames' values at 0 or 255.
"""

from __future__ import annotations

import math
import os
import sys
import tempfile

import numpy as np
import torch

from .. import weights, work_sg1
from ..common import Cell
from ..reference import stylegan1 as ref
from ..reference.stylegan2 import precision, to_uint8
from .render import Clip, State, _call, _seeds, compare, make_sink
from .render import counts, release, window  # noqa: F401  (the cell's, as render.py's cells')


def leaves(config: dict) -> list[tuple[str, tuple, str]]:
    """(key, shape, init) of every G_style tensor and stored noise map, in
    lernapparat's layout; init as `weights.make` takes it."""
    s, ch = config["style_dim"], config["channels"]
    out = []
    for i in range(config["n_mlp"]):
        out += [(f"g_mapping.dense{i}.weight", (s, s), "mapping"), (f"g_mapping.dense{i}.bias", (s,), "bias")]
    for i, (r, cin, c) in enumerate(work_sg1.blocks(config)):
        key = f"g_synthesis.blocks.{r}x{r}"
        if i == 0:
            out += [(f"{key}.const", (1, c, 4, 4), "normal"), (f"{key}.bias", (c,), "bias"),
                    (f"{key}.conv.weight", (c, c, 3, 3), "normal"), (f"{key}.conv.bias", (c,), "bias")]
        else:
            out += [(f"{key}.conv0_up.weight", (c, cin, 3, 3), "normal"), (f"{key}.conv0_up.bias", (c,), "bias"),
                    (f"{key}.conv1.weight", (c, c, 3, 3), "normal"), (f"{key}.conv1.bias", (c,), "bias")]
        for epi in ("epi1", "epi2"):
            out += [(f"{key}.{epi}.top_epi.noise.weight", (c,), "noise_w"),
                    (f"{key}.{epi}.style_mod.lin.weight", (2 * c, s), "normal"),
                    (f"{key}.{epi}.style_mod.lin.bias", (2 * c,), "bias")]
    out += [("g_synthesis.torgb.weight", (3, ch[-1], 1, 1), "rgb"), ("g_synthesis.torgb.bias", (3,), "bias")]
    return out + [(f"noises.noise_{i}", (1, 1, r, r), "normal") for i, (r, _, _) in enumerate(work_sg1.blocks(config))]


def make_weights(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    a = config["assumed"]
    gen = torch.Generator(device=device).manual_seed(seed)
    return weights.make(leaves(config), gen, device, kind="trained", spread=a["spread"],
                        to_rgb_gain=a["to_rgb_gain"], lr_mlp=config["lr_mlp"])


def make_clips(cfg: dict, tr: dict, p: dict, seed: int, device) -> list[Clip]:
    frames, every = tr["frames"], tr["keyframe_every"]
    n_key = frames // every + 2
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    clips = []
    for _ in range(tr["clips"]):
        with torch.no_grad(), precision(False):
            keys = ref.mapping(p, torch.randn((n_key, cfg["style_dim"]), generator=gen, device=device), cfg["n_mlp"])
        t = torch.arange(frames, device=device, dtype=torch.float32) / every
        lo = t.floor().long()
        frac = (t - lo)[:, None]
        w = keys[lo] * (1 - frac) + keys[lo + 1] * frac
        latents = w[:, None, :].expand(frames, cfg["n_latent"], -1).contiguous().cpu().numpy()
        noise = [torch.randn((frames, 1, r, r), generator=gen, device=device).cpu().numpy()
                 if r <= tr["noise_max_width"] else None for r, _, _ in work_sg1.blocks(cfg)]
        judged = rng.choice(frames - 1, tr["judged_per_call"] - 1, replace=False)
        clips.append(Clip(latents, noise, np.full(frames, tr["truncation"], np.float32),
                          np.sort(np.append(judged, frames - 1))))
    return clips


def setup(cell: Cell, seed: int, device: str = "cuda") -> State:
    from maua_tpu_torch.models import load_stylegan1
    import maua_tpu_torch.render.frames as frames_mod

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    s = _seeds(seed)
    p = make_weights(cfg, s["weights"], dev)
    out_dir = tempfile.mkdtemp(prefix="portbench-render-sg1-")
    ckpt = os.path.join(out_dir, "g_style.pt")
    torch.save({k: v.cpu() for k, v in p.items()}, ckpt)
    gen = load_stylegan1(ckpt, device=dev)
    tl = gen.mean_latent(torch.Generator(device=dev).manual_seed(s["mean"]), n_latent=tr["mean_latent_z"])
    sink = make_sink()
    frames_mod.VideoWriter = sink  # render() builds its writer from this name
    state = State(cell, seed, dev, p, gen, tl, make_clips(cfg, tr, p, s["clips"], dev), sink,
                  os.path.join(out_dir, "clip.mp4"))
    c0 = state.clips[0]
    warm = 2 * tr["batch"]
    _call(state, Clip(c0.latents[:warm], [None if n is None else n[:warm] for n in c0.noise], c0.truncation[:warm],
                      np.array([], dtype=np.int64)), clip_id=-1)
    state.kept.clear()
    return state


def work(state: State) -> dict:
    """What the window's calls needed, from the configuration's shapes."""
    cfg, tr = state.cell.config, state.cell.traffic
    batches = state.calls * -(-tr["frames"] // tr["batch"])
    return {"flops": work_sg1.frame_flops(cfg) * state.frames_delivered,
            "upfirdn2d_bytes": work_sg1.blur_bytes(cfg) * tr["batch"] * batches}


def reference_frames(state: State, items: list, tf32: bool = False) -> list[np.ndarray]:
    """The reference's uint8 frames for (clip, frame) pairs, 8 at a time."""
    cfg, tr = state.cell.config, state.cell.traffic
    dev, p = state.device, state.gw
    out = []
    with torch.no_grad(), precision(tf32):
        z = torch.randn((tr["mean_latent_z"], cfg["style_dim"]),
                        generator=torch.Generator(device=dev).manual_seed(_seeds(state.seed)["mean"]), device=dev)
        mean = ref.mean_latent(p, z)
        for at in range(0, len(items), 8):
            block = items[at: at + 8]
            clips = [state.clips[c] for c, _ in block]
            idx = [f for _, f in block]
            w = torch.from_numpy(np.stack([c.latents[f] for c, f in zip(clips, idx)])).to(dev)
            t = torch.from_numpy(np.stack([c.truncation[f] for c, f in zip(clips, idx)])).to(dev)
            noise = [p[f"noises.noise_{i}"] if buf is None else
                     torch.from_numpy(np.stack([c.noise[i][f] for c, f in zip(clips, idx)])).to(dev)
                     for i, buf in enumerate(clips[0].noise)]
            img = ref.synthesis(p, ref.truncate(w, t, mean, cfg["truncation_cutoff"]), noise, cfg["size"])
            out.extend(to_uint8(img).cpu().numpy())
    return out


def saturated_share(frames: list[np.ndarray]) -> float:
    """Share of the frames' uint8 values at 0 or 255."""
    return float(sum(((f == 0) | (f == 255)).sum() for f in frames) / sum(f.size for f in frames))


def judge(state: State) -> tuple[dict[str, float], int]:
    """The numbers compared, and how many judged frames failed to arrive."""
    kept = state.kept
    want = sum(len(state.clips[c % len(state.clips)].judged) for c in range(state.calls))
    missing = want - len(kept)
    if not kept:
        return {"max_level_diff": math.inf, "mismatch_share": math.inf}, missing
    frames = [fr for _, _, fr in kept]
    numbers = compare(frames, reference_frames(state, [(c, f) for c, f, _ in kept]))
    numbers["saturated_share"] = saturated_share(frames)
    print(f"judged frames: {len(frames)}, share of values at 0 or 255 {numbers['saturated_share']!r}",
          file=sys.stderr, flush=True)
    return numbers, missing


def control(state: State, items: list | None = None) -> dict[str, float]:
    """The reference in TF32 put in the program's place, judged by the fp32
    reference; `items` None takes every clip's judged frames."""
    if items is None:
        items = [(c, int(f)) for c, clip in enumerate(state.clips) for f in clip.judged]
    return compare(reference_frames(state, items, tf32=True), reference_frames(state, items))
