"""Rendering cells: repeated calls of `maua_tpu_torch.render.render` on
seeded clips, each frame handed to the harness's frame sink in place of the
video encoder.

Set-up makes the generator's weights and the mean latent's z on the device
from the seed, builds the program's Generator, and makes `clips` distinct
clips: W+ latents interpolated between seeded keyframes (keyframe W from the
reference mapping network of seeded z), per-frame noise on the layers no
wider than `noise_max_width` (the other layers take the stored noise
buffers), and a constant truncation timeline with the program's mean latent.
One short call warms up every shape. The window calls render() on the clips
in turn until `--seconds` have passed; `render_fps` is the frames the sink
received over the window's time.

The sink keeps `judged_per_call` frames of every call (their indices drawn
from the seed, the clip's last frame always among them, which lies in the
half-padded last batch). Once the window has closed and the program is
freed, the reference renders those frames again and the comparison is of
uint8 levels: the largest difference and the share of values that differ.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import bytes as work_bytes
from .. import flops, weights
from ..common import Cell, Spans
from ..reference import stylegan2 as ref

@dataclass
class Clip:
    latents: np.ndarray  # [F, n_latent, D]
    noise: list  # per layer [F, 1, r, r] or None
    truncation: np.ndarray  # [F]
    judged: np.ndarray  # frame indices the sink keeps


@dataclass
class State:
    cell: Cell
    seed: int
    device: torch.device
    gw: dict
    gen: Optional[torch.nn.Module]
    truncation_latent: torch.Tensor
    clips: list
    sink: type
    out_file: str
    kept: list = field(default_factory=list)  # (clip index, frame index, [H, W, 3] uint8)
    frames_delivered: int = 0
    frames_asked: int = 0
    calls: int = 0
    spans: Spans = field(default_factory=Spans)


def _seeds(seed: int) -> dict[str, int]:
    base = np.random.SeedSequence(seed).generate_state(4, dtype=np.uint64)
    return dict(zip(("weights", "mean", "clips", "judge"), (int(x) % (2**63) for x in base)))


def make_sink():
    """A VideoWriter stand-in that counts every frame and copies those asked for."""

    class Sink:
        keep: set = set()
        kept: list = []
        clip = 0
        written = 0

        def __init__(self, output_file, width, height, fps, **_):
            self.shape = (height, width, 3)
            self.n = 0

        def write(self, frame: np.ndarray) -> None:
            if frame.shape != self.shape or frame.dtype != np.uint8:
                raise ValueError(f"frame {frame.dtype} {frame.shape}, want uint8 {self.shape}")
            if self.n in Sink.keep:
                Sink.kept.append((Sink.clip, self.n, frame.copy()))
            self.n += 1
            Sink.written += 1

        def close(self) -> None:
            pass

    return Sink


def make_clips(cfg: dict, tr: dict, gw: dict, seed: int, device) -> list[Clip]:
    size = cfg["size"]
    n_lat = ref.n_latent(size)
    frames, every = tr["frames"], tr["keyframe_every"]
    n_key = frames // every + 2
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    n_layers = 2 * int(math.log2(size)) - 3
    clips = []
    for _ in range(tr["clips"]):
        with torch.no_grad(), ref.precision(False):
            keys = ref.mapping(gw, torch.randn((n_key, cfg["style_dim"]), generator=gen, device=device), cfg["n_mlp"])
        t = torch.arange(frames, device=device, dtype=torch.float32) / every
        lo = t.floor().long()
        frac = (t - lo)[:, None]
        w = keys[lo] * (1 - frac) + keys[lo + 1] * frac
        latents = w[:, None, :].expand(frames, n_lat, -1).contiguous().cpu().numpy()
        noise = []
        for i in range(n_layers):
            r = 2 ** ((i + 5) // 2)
            noise.append(torch.randn((frames, 1, r, r), generator=gen, device=device).cpu().numpy()
                         if r <= tr["noise_max_width"] else None)
        judged = rng.choice(frames - 1, tr["judged_per_call"] - 1, replace=False)
        clips.append(Clip(latents, noise, np.full(frames, tr["truncation"], np.float32),
                          np.sort(np.append(judged, frames - 1))))
    return clips


def setup(cell: Cell, seed: int, device: str = "cuda") -> State:
    from maua_tpu_torch.models import Generator
    import maua_tpu_torch.render.frames as frames_mod

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    s = _seeds(seed)
    gw = weights.generator_weights(cfg, s["weights"], dev, kind="trained", spread=tr["weights"]["spread"],
                                   to_rgb_gain=tr["weights"]["to_rgb_gain"])
    gen = Generator(size=cfg["size"], style_dim=cfg["style_dim"], n_mlp=cfg["n_mlp"],
                    channel_multiplier=cfg["channel_multiplier"], channel_max=cfg["channel_max"],
                    constant_input=True, precision=cfg["precision"]).to(dev).eval()
    weights.load(gen, gw)
    mean_rng = torch.Generator(device=dev).manual_seed(s["mean"])
    tl = gen.mean_latent(mean_rng, n_latent=tr["mean_latent_z"])
    sink = make_sink()
    frames_mod.VideoWriter = sink  # render() builds its writer from this name
    out_dir = tempfile.mkdtemp(prefix="portbench-render-")
    state = State(cell, seed, dev, gw, gen, tl, make_clips(cfg, tr, gw, s["clips"], dev), sink,
                  os.path.join(out_dir, "clip.mp4"))
    c0 = state.clips[0]
    warm = 2 * tr["batch"]
    _call(state, Clip(c0.latents[:warm], [None if n is None else n[:warm] for n in c0.noise], c0.truncation[:warm],
                      np.array([], dtype=np.int64)), clip_id=-1)
    state.kept.clear()
    return state


def _call(state: State, clip: Clip, clip_id: int) -> int:
    from maua_tpu_torch.render import render

    sink = state.sink
    sink.keep, sink.kept, sink.clip, sink.written = set(clip.judged.tolist()), [], clip_id, 0
    render(state.gen, None, clip.latents, clip.noise, state.out_file, batch_size=state.cell.traffic["batch"],
           fps=state.cell.traffic["fps"], truncation=clip.truncation, truncation_latent=state.truncation_latent,
           randomize_noise=False, device=state.device)
    state.kept.extend(sink.kept)
    return sink.written


def window(state: State, seconds: float, traced: bool = False) -> dict:
    """Call render() on the clips in turn until `seconds` have passed."""
    frames = state.cell.traffic["frames"]
    with state.spans("window"):
        t0 = time.perf_counter()
        while True:
            clip_id = state.calls % len(state.clips)
            with state.spans("render_call"):
                state.frames_delivered += _call(state, state.clips[clip_id], clip_id)
            state.frames_asked += frames
            state.calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    return {"window_s": window_s, "render_fps": state.frames_delivered / window_s}


def work(state: State) -> dict:
    """What the window's calls needed, from the configuration's shapes."""
    tr = state.cell.traffic
    batches = state.calls * -(-tr["frames"] // tr["batch"])
    return {"flops": flops.render_frame_flops(state.cell.config) * state.frames_delivered,
            "fused_bias_act_bytes": work_bytes.render_batch_bytes(state.cell.config, tr["batch"]) * batches}


def counts(state: State, missing: int) -> tuple[int, int]:
    """(frames the window's calls asked for, frames not delivered or judged frames missing)."""
    return state.frames_asked, state.frames_asked - state.frames_delivered + missing


def release(state: State) -> None:
    state.gen = None
    shutil.rmtree(os.path.dirname(state.out_file), ignore_errors=True)
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_frames(state: State, items: list, tf32: bool = False) -> list[np.ndarray]:
    """The reference's uint8 frames for (clip, frame) pairs, 8 at a time."""
    cfg, tr = state.cell.config, state.cell.traffic
    dev = state.device
    s = _seeds(state.seed)
    gw = state.gw
    out = []
    with torch.no_grad(), ref.precision(tf32):
        z = torch.randn((tr["mean_latent_z"], cfg["style_dim"]),
                        generator=torch.Generator(device=dev).manual_seed(s["mean"]), device=dev)
        mean = ref.mean_latent(gw, z, cfg["n_mlp"])
        for at in range(0, len(items), 8):
            block = items[at: at + 8]
            clips = [state.clips[c] for c, _ in block]
            idx = [f for _, f in block]
            w = torch.from_numpy(np.stack([c.latents[f] for c, f in zip(clips, idx)])).to(dev)
            t = torch.from_numpy(np.stack([c.truncation[f] for c, f in zip(clips, idx)])).to(dev)
            noise = []
            for i, buf in enumerate(clips[0].noise):
                if buf is None:
                    noise.append(gw[f"noises.noise_{i}"])
                else:
                    noise.append(torch.from_numpy(np.stack([c.noise[i][f] for c, f in zip(clips, idx)])).to(dev))
            img = ref.synthesis(gw, ref.truncate(w, t, mean), noise, cfg["size"])
            out.extend(ref.to_uint8(img).cpu().numpy())
    return out


def compare(a: list[np.ndarray], b: list[np.ndarray]) -> dict[str, float]:
    diff = [np.abs(x.astype(np.int16) - y.astype(np.int16)) for x, y in zip(a, b)]
    return {"max_level_diff": float(max(d.max() for d in diff)),
            "mismatch_share": float(sum((d > 0).sum() for d in diff) / sum(d.size for d in diff))}


def judge(state: State) -> tuple[dict[str, float], int]:
    """The numbers compared, and how many judged frames failed to arrive."""
    kept = state.kept
    want = sum(len(state.clips[c % len(state.clips)].judged) for c in range(state.calls))
    missing = want - len(kept)
    if not kept:
        return {"max_level_diff": math.inf, "mismatch_share": math.inf}, missing
    refs = reference_frames(state, [(c, f) for c, f, _ in kept])
    return compare([fr for _, _, fr in kept], refs), missing


def control(state: State, items: list) -> dict[str, float]:
    """The reference in TF32 put in the program's place, judged by the fp32 reference."""
    return compare(reference_frames(state, items, tf32=True), reference_frames(state, items))
