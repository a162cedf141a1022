"""The streaming frame renderer — the inference hot loop (counterpart of
maua_tpu/render/frames.py:45-253).

* The whole timeline (W+ latents, per-layer noise, truncation, bend and
  rewrite modulations) is padded to whole batches once and staged on the
  device when it fits under `max_device_timeline_bytes`; each batch is then a
  slice on the device. Larger timelines are uploaded batch by batch.
* One batch = Generator forward from W+ (`input_is_latent=True`) + bends +
  rewrites (`torch.func.functional_call` overrides) + `_pack_frames`, which
  crops/resizes widescreen output and packs uint8 NHWC on the device, so only
  uint8 crosses to the host.
* Double buffering on a CUDA device: batch k's uint8 frames are copied into a
  pinned host buffer with a non-blocking copy and a CUDA event; the host waits
  for that event only after batch k+1 has been queued, so the copy overlaps
  the next batch's compute.
* A writer thread drains a bounded queue (4 batches) into the `VideoWriter`.
"""

from __future__ import annotations

import queue
from threading import Thread
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..reactive.bend import Bend
from ..reactive.rewrite import Rewrite, apply_rewrites
from .video import VideoWriter

_WIDESCREEN = {1920: (1920, 1080), 1080: (1080, 1920)}  # out_size -> (width, height)


def _pack_frames(img: torch.Tensor, out_size: Optional[int]) -> torch.Tensor:
    """[B, 3, H, W] in [-1, 1] -> [B, H', W', 3] uint8 on the same device.
    A 2048-wide (or tall) image for out_size 1920 (1080) is center-cropped to
    1824 and resized bilinearly to 1920x1080 (1080x1920)."""
    if out_size in _WIDESCREEN and (img.shape[-1] == 2048 or img.shape[-2] == 2048):
        if out_size == 1920:
            img = img[:, :, :, 112:-112] if img.shape[-1] == 2048 else img
        else:
            img = img[:, :, 112:-112, :] if img.shape[-2] == 2048 else img
        w, h = _WIDESCREEN[out_size]
        img = F.interpolate(img, size=(h, w), mode="bilinear", align_corners=False, antialias=False)
    img = (img.clamp(-1.0, 1.0) + 1.0) * 127.5 + 0.5  # round to nearest on the cast
    return img.to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float32)


def render(
    generator,
    variables: Optional[Mapping[str, torch.Tensor]],
    latents,
    noise: Sequence[Optional[Any]],
    output_file: str,
    batch_size: int = 8,
    duration: Optional[float] = None,
    fps: Optional[float] = None,
    truncation: Any = 1.0,
    truncation_latent: Optional[Any] = None,
    bends: Sequence[Bend] = (),
    rewrites: Sequence[Rewrite] = (),
    randomize_noise: bool = False,
    out_size: Optional[int] = None,
    audio_file: Optional[str] = None,
    offset: float = 0.0,
    ffmpeg_preset: str = "slow",
    mesh=None,
    progress: bool = True,
    max_device_timeline_bytes: int = 8 << 30,
    device: DeviceLike = None,
) -> str:
    """Render a timeline to a video file and return its path.

    generator: a `Generator` already on `device` (default `cuda`; raises
    RuntimeError when there is none). variables: None to use the generator's
    own weights, or a {state-dict key: tensor} mapping that overrides them.
    latents: [n_frames, n_latent, D]; noise: per-layer [n_frames, 1, h, w] or
    None; truncation: a float or an [n_frames] timeline. `progress` is
    accepted for signature compatibility and prints nothing."""
    if mesh is not None:
        raise NotImplementedError("multi-GPU rendering (mesh=) is not ported yet")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    gen_device = next(generator.parameters()).device
    if gen_device != device:
        raise ValueError(f"generator is on {gen_device} but render runs on {device}; move it with .to(device)")

    latents = _host(latents)
    n_frames = len(latents)
    if fps is None:
        fps = n_frames / duration if duration else 30.0

    tensor_trunc = not isinstance(truncation, float)
    if truncation_latent is None and (tensor_trunc or truncation != 1.0):
        raise ValueError(
            "truncation != 1 requires truncation_latent — precompute it with Generator.mean_latent"
        )
    apply_trunc = truncation_latent is not None and (tensor_trunc or truncation != 1.0)
    if truncation_latent is not None:
        truncation_latent = torch.as_tensor(_host(truncation_latent), device=device)

    noise = [None if n is None else _host(n) for n in noise or []]
    noise += [None] * (generator.num_layers - len(noise))

    # ---- pad timelines once so every batch has the same shape ----
    n_padded = -(-n_frames // batch_size) * batch_size

    def pad_t(x):
        if x is None or len(x) == n_padded:
            return x
        return np.concatenate([x, np.repeat(x[-1:], n_padded - len(x), axis=0)])

    latents = pad_t(latents)
    noise = [pad_t(n) for n in noise]
    trunc_t = pad_t(_host(truncation).reshape(-1)) if tensor_trunc else None
    bend_mods = [None if b.modulation is None else pad_t(_host(b.modulation)) for b in bends]
    rw_mods = [None if r.modulation is None else pad_t(_host(r.modulation)) for r in rewrites]

    # ---- stage the timeline on the device when it fits ----
    total_bytes = latents.nbytes + sum(0 if n is None else n.nbytes for n in noise)
    if total_bytes <= max_device_timeline_bytes:
        def stage(x):
            return None if x is None else torch.from_numpy(x).to(device)

        latents, trunc_t = stage(latents), stage(trunc_t)
        noise = [stage(n) for n in noise]
        bend_mods = [stage(m) for m in bend_mods]
        rw_mods = [stage(m) for m in rw_mods]

        def take(x, sl):
            return None if x is None else x[sl]
    else:
        def take(x, sl):
            return None if x is None else torch.from_numpy(np.ascontiguousarray(x[sl])).to(device)

    own = {**dict(generator.named_parameters()), **dict(generator.named_buffers())}
    params = own if variables is None else {**own, **variables}

    def synth_batch(sl: slice) -> torch.Tensor:
        pairs = [
            (b.layer, (lambda x, _t=b.transform, _m=take(m, sl): _t(x, _m)))
            for b, m in zip(bends, bend_mods)
        ]
        if not apply_trunc:
            trunc_b = 1.0
        else:
            trunc_b = take(trunc_t, sl) if tensor_trunc else truncation
        kwargs = dict(
            input_is_latent=True,
            noise=[take(n, sl) for n in noise],
            randomize_noise=randomize_noise,
            truncation=trunc_b,
            truncation_latent=truncation_latent,
            bends=pairs,
        )
        overrides = dict(variables) if variables is not None else {}
        if rewrites:
            overrides.update(apply_rewrites(params, rewrites, [take(m, sl) for m in rw_mods]))
        if overrides:
            img, _ = torch.func.functional_call(generator, overrides, (take(latents, sl),), kwargs)
        else:
            img, _ = generator(take(latents, sl), **kwargs)
        return _pack_frames(img, out_size)

    # ---- writer thread behind a bounded queue ----
    width, height = _WIDESCREEN.get(out_size) or ((generator.size,) * 2 if out_size is None else (out_size,) * 2)
    writer = VideoWriter(
        output_file, width, height, fps,
        audio_file=audio_file, offset=offset, duration=duration, ffmpeg_preset=ffmpeg_preset,
    )
    frame_q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(maxsize=4)
    errors: list[BaseException] = []

    def write_loop():
        remaining = n_frames
        while remaining > 0:
            batch = frame_q.get()
            if batch is None:  # the producer stopped early
                return
            take_n = min(remaining, len(batch))
            if not errors:  # after a failure keep draining so the producer never blocks
                try:
                    for i in range(take_n):
                        writer.write(batch[i])
                except Exception as e:  # re-raised on the calling thread
                    errors.append(e)
            remaining -= take_n

    wt = Thread(target=write_loop, daemon=True)
    wt.start()

    cuda = device.type == "cuda"
    pinned: list[torch.Tensor] = []
    if cuda:
        events = [torch.cuda.Event() for _ in range(2)]
    finished = False
    try:
        with torch.inference_mode():
            pending = None  # slot of the batch whose copy is in flight
            for k, start in enumerate(range(0, n_padded, batch_size)):
                frames = synth_batch(slice(start, start + batch_size))
                if not cuda:
                    frame_q.put(frames.numpy())
                    continue
                if not pinned:
                    pinned = [torch.empty(frames.shape, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
                slot = k % 2
                pinned[slot].copy_(frames, non_blocking=True)
                events[slot].record()
                if pending is not None:  # fetch batch k-1 while batch k computes
                    events[pending].synchronize()
                    frame_q.put(pinned[pending].numpy().copy())
                pending = slot
            if pending is not None:
                events[pending].synchronize()
                frame_q.put(pinned[pending].numpy().copy())
        finished = True
    finally:
        if not finished:
            frame_q.put(None)
        wt.join()
        writer.close()
    if errors:
        raise errors[0]
    return output_file
