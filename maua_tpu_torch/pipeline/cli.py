"""CLI for audio-reactive generation with the plugin-file protocol
(counterpart of maua_tpu/pipeline/cli.py).

A plugin .py supplies any of initialize / get_latents / get_noise / get_bends
/ get_rewrites / get_truncation (each missing one falls back to the default)
plus an optional OVERRIDE dict whose entries override the CLI's arguments.
Plugins for the port are written in torch against maua_tpu_torch.audio and
maua_tpu_torch.reactive (see maua_tpu_torch/examples/).

Run:  python -m maua_tpu_torch.pipeline.cli --ckpt g.pt --audio_file track.wav \\
          [--audioreactive_file plugin.py] [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import traceback

from .generate import generate

PLUGIN_FUNCS = ["initialize", "get_latents", "get_noise", "get_bends", "get_rewrites", "get_truncation"]


def load_plugin(path: str | None):
    """Import a plugin file and pull out the reactive functions + OVERRIDE."""
    funcs = {name: None for name in PLUGIN_FUNCS}
    override = {}
    if path is None:
        return funcs, override
    spec = importlib.util.spec_from_file_location("maua_reactive_plugin", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["maua_reactive_plugin"] = mod
    spec.loader.exec_module(mod)
    for name in PLUGIN_FUNCS:
        fn = getattr(mod, name, None)
        if fn is None:
            print(f"No '{name}' function found in --audioreactive_file, using default...")
        funcs[name] = fn
    override = getattr(mod, "OVERRIDE", {})
    return funcs, override


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="maua_tpu_torch audio-reactive video generation")
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--audio_file", type=str, required=True)
    parser.add_argument("--audioreactive_file", type=str, default=None)
    parser.add_argument("--output_dir", type=str, default="./output")
    parser.add_argument("--offset", type=float, default=0)
    parser.add_argument("--duration", type=float, default=-1)
    parser.add_argument("--latent_file", type=str, default=None)
    parser.add_argument("--shuffle_latents", action="store_true")
    parser.add_argument("--G_res", type=int, default=1024)
    parser.add_argument("--out_size", type=int, default=1024, help="512, 1024, 1920 or 1080")
    parser.add_argument("--fps", type=float, default=30)
    parser.add_argument("--latent_count", type=int, default=12)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--truncation", type=float, default=1.0)
    parser.add_argument("--stylegan1", action="store_true")
    parser.add_argument("--noconst", action="store_true")
    parser.add_argument("--latent_dim", type=int, default=512)
    parser.add_argument("--n_mlp", type=int, default=8)
    parser.add_argument("--channel_multiplier", type=int, default=2)
    parser.add_argument("--randomize_noise", action="store_true")
    parser.add_argument("--base_res_factor", type=float, default=1)
    parser.add_argument("--ffmpeg_preset", type=str, default="slow")
    parser.add_argument("--output_file", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    try:
        funcs, override = load_plugin(args.audioreactive_file)
    except Exception:
        print("Error while loading --audioreactive_file...")
        traceback.print_exc()
        return 1

    arg_dict = vars(args).copy()
    arg_dict.pop("audioreactive_file")
    # the plugin's OVERRIDE wins over the command line
    for k, v in override.items():
        arg_dict[k] = v
        setattr(args, k, v)

    ckpt = arg_dict.pop("ckpt")
    audio_file = arg_dict.pop("audio_file")
    generate(ckpt=ckpt, audio_file=audio_file, **funcs, **arg_dict, args=args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
