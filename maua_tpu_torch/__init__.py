"""maua_tpu_torch — the PyTorch/CUDA port of maua_tpu for NVIDIA Hopper.

Same modules and class names as the JAX package; parameters carry the
rosinality state-dict keys, so a `g_ema` loads with `load_state_dict(strict=True)`.
The paths covered so far: rosinality `.pt` checkpoint -> StyleGAN2 `Generator`
-> streaming `render()`; and StyleGAN2 training without augmentation (D, lazy
R1, G, lazy path length, lookahead, EMA) from MREC record shards. The fused
bias + leaky-ReLU and its gradient (csrc/fused_bias_act.cu) and upfirdn2d
(csrc/upfirdn2d.cu) run as hand-written CUDA kernels on CUDA tensors.

  ops/       fused bias + leaky-ReLU and upfirdn2d (kernels + plain forms, autograd Functions), kernel build
  models/    StyleGAN2 Generator, Discriminator and their blocks
  io/        rosinality checkpoint loading, weights carried across from maua_tpu
  reactive/  Bend and Rewrite records
  render/    render() and the video writers
  train/     losses, EMA, lookahead, the train step and its phases, checkpoints, the train CLI
  data/      MREC record shards, synthetic datasets, the threaded loader

Entry points: `maua_tpu_torch.io.load_generator(path, device=...)`,
`maua_tpu_torch.render.render(generator, None, latents, noise, out, device=...)`
and `python -m maua_tpu_torch.train.cli --path SHARDS --no-augment [--device ...]`.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
