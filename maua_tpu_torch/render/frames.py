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
* Frame-parallel rendering (`mesh=`, a list of torch devices from
  `parallel.get_mesh`, the first of which is `device`): each mesh device
  holds a copy of the generator and synthesises its share of every batch
  (the batch zero-padded to a multiple of the mesh with `pad_to_multiple`
  and cut in equal parts; a rewrite's modulation stays whole, since it makes
  one weight for the batch); the uint8 frames come back to `device` in order.
  This is the reference's DataParallel over frame batches.
* While a profiler records, a call is a `render` span around
  `render.prepare` (checks, host conversion and padding, replicas, the
  writer), `render.stage` (the upload), one `render.batch` (synthesis and
  the copy's enqueue) and one `render.fetch` (the wait, the copy out, the
  queue put) per batch, and `render.finish` (the last fetch, the writer's
  join and close); telemetry/profiling.py.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import queue
from threading import Thread
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..parallel import pad_to_multiple
from ..reactive.bend import Bend
from ..reactive.rewrite import Rewrite, apply_rewrites
from ..telemetry.profiling import phase
from .video import VideoWriter

_WIDESCREEN = {1920: (1920, 1080), 1080: (1080, 1920)}  # out_size -> (width, height)
_CALLS = itertools.count()  # render() calls: the request id of their spans


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
    None; truncation: a float or an [n_frames] timeline. mesh: None, or
    the devices of a frame-parallel render (`parallel.get_mesh`), the first
    of which must be `device`. `progress` is accepted for signature
    compatibility and prints nothing."""
    serial = next(_CALLS)
    with phase("render", request=serial):
        with phase("render.prepare", request=serial):
            device = resolve_device(device)
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            gen_device = next(generator.parameters()).device
            if gen_device != device:
                raise ValueError(f"generator is on {gen_device} but render runs on {device}; move it with .to(device)")
            if mesh is not None:
                mesh = [torch.device(d) for d in mesh]
                mesh = [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
                        for d in mesh]
                if not mesh or mesh[0] != device:
                    raise ValueError(f"the mesh {mesh} must start with the render device {device}")

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

            # ---- the timeline goes to the device when it fits (render.stage) ----
            total_bytes = latents.nbytes + sum(0 if n is None else n.nbytes for n in noise)
            staged = total_bytes <= max_device_timeline_bytes

            def stage(x):
                return None if x is None else torch.from_numpy(x).to(device)

            def take(x, sl):
                if x is None:
                    return None
                return x[sl] if staged else torch.from_numpy(np.ascontiguousarray(x[sl])).to(device)

            def params_of(gen):
                return {**dict(gen.named_parameters()), **dict(gen.named_buffers())}

            def to(x, dev):
                return x.to(dev) if isinstance(x, torch.Tensor) else x

            # one replica of the generator (and of the overrides) per mesh device
            replicas = [(device, generator, variables)]
            for dev in (mesh or [device])[1:]:
                gen_d = generator if dev == device else copy.deepcopy(generator).to(dev)
                vars_d = None if variables is None else {k: v.to(dev) for k, v in variables.items()}
                replicas.append((dev, gen_d, vars_d))
            replica_params = []  # what a rewrite transforms: each replica's own tensors, overridden by `variables`
            for _, gen_d, vars_d in replicas:
                own = params_of(gen_d)
                replica_params.append(own if vars_d is None else {**own, **vars_d})
            tl_d = [to(truncation_latent, dev) for dev, _, _ in replicas]

            def forward(r: int, latent_b, noise_b, trunc_b, bmods_b, rmods_b) -> torch.Tensor:
                """Replica r's uint8 frames of one (part of a) batch, its inputs on its device."""
                _, gen, gvars = replicas[r]
                pairs = [(b.layer, (lambda x, _t=b.transform, _m=m: _t(x, _m))) for b, m in zip(bends, bmods_b)]
                kwargs = dict(input_is_latent=True, noise=noise_b, randomize_noise=randomize_noise, truncation=trunc_b,
                              truncation_latent=tl_d[r], bends=pairs)
                overrides = dict(gvars) if gvars is not None else {}
                if rewrites:
                    overrides.update(apply_rewrites(replica_params[r], rewrites, rmods_b))
                if overrides:
                    img, _ = torch.func.functional_call(gen, overrides, (latent_b,), kwargs)
                else:
                    img, _ = gen(latent_b, **kwargs)
                return _pack_frames(img, out_size)

            def synth_batch(sl: slice) -> torch.Tensor:
                trunc_b = (take(trunc_t, sl) if tensor_trunc else truncation) if apply_trunc else 1.0
                inputs = [take(latents, sl), [take(n, sl) for n in noise], trunc_b,
                          [take(m, sl) for m in bend_mods], [take(m, sl) for m in rw_mods]]
                if len(replicas) == 1:
                    return forward(0, *inputs)
                # frame-parallel: pad the batch to a multiple of the mesh, give each
                # device an equal part, gather the frames in order on `device`
                n, parts = inputs[0].shape[0], len(replicas)

                def split(x):
                    if not isinstance(x, torch.Tensor):  # None, or a float truncation
                        return [x] * parts
                    return pad_to_multiple(x, parts)[0].chunk(parts)

                def split_list(xs):
                    cols = [split(x) for x in xs]
                    return [[c[r] for c in cols] for r in range(parts)]

                lat, trunc = split(inputs[0]), split(inputs[2])
                noises, bmods = split_list(inputs[1]), split_list(inputs[3])
                frames = []
                for r, (dev, _, _) in enumerate(replicas):
                    # a rewrite makes one weight per batch: every replica takes the whole batch's modulation
                    frames.append(forward(r, lat[r].to(dev), [to(x, dev) for x in noises[r]], to(trunc[r], dev),
                                          [to(x, dev) for x in bmods[r]], [to(x, dev) for x in inputs[4]]))
                return torch.cat([f.to(device) for f in frames])[:n]

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

            def fetch(slot: int, k: int) -> None:
                """Hand batch k, copied into pinned slot `slot`, to the writer."""
                with phase("render.fetch", request=(serial, k)):
                    events[slot].synchronize()
                    frame_q.put(pinned[slot].numpy().copy())

        finished = False
        with contextlib.ExitStack() as finish:
            try:
                with phase("render.stage", request=serial):
                    if staged:
                        latents, trunc_t = stage(latents), stage(trunc_t)
                        noise = [stage(n) for n in noise]
                        bend_mods = [stage(m) for m in bend_mods]
                        rw_mods = [stage(m) for m in rw_mods]
                pending = None  # slot of the batch whose copy is in flight
                with torch.inference_mode():
                    for k, start in enumerate(range(0, n_padded, batch_size)):
                        with phase("render.batch", request=(serial, k)):
                            frames = synth_batch(slice(start, start + batch_size))
                            if cuda:
                                if not pinned:
                                    pinned = [torch.empty(frames.shape, dtype=torch.uint8, pin_memory=True)
                                              for _ in range(2)]
                                slot = k % 2
                                pinned[slot].copy_(frames, non_blocking=True)
                                events[slot].record()
                        if not cuda:
                            with phase("render.fetch", request=(serial, k)):
                                frame_q.put(frames.numpy())
                            continue
                        if pending is not None:  # fetch batch k-1 while batch k computes
                            fetch(pending, k - 1)
                        pending = slot
                finish.enter_context(phase("render.finish", request=serial))
                if pending is not None:
                    fetch(pending, k)
                finished = True
            finally:
                if not finished:
                    frame_q.put(None)
                wt.join()
                writer.close()
        if errors:
            raise errors[0]
        return output_file
