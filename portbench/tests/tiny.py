"""Tiny copies of the benchmark's cells for the CPU tests: the same drivers,
traffic and limits, at 32^2 with 32 channels and a few frames or records."""

from __future__ import annotations

from portbench.common import Cell, find_cell


def tiny(name: str) -> Cell:
    cell = find_cell(name)
    cell.config = dict(cell.config, size=32, channel_max=32)
    tr = dict(cell.traffic)
    if tr["driver"] == "render":
        tr.update(frames=12, batch=4, clips=2, keyframe_every=4, noise_max_width=16, mean_latent_z=256,
                  judged_per_call=3)
    else:
        # the card's default warp; on the CPU the CLI would pick the gather warp, which is no identity at p = 0
        tr.update(batch=8, records=40, num_workers=2, extra_args=["--ada_warp", "fft"])
    cell.traffic = tr
    return cell
