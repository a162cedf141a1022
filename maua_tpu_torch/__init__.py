"""maua_tpu_torch — the PyTorch/CUDA port of maua_tpu for NVIDIA Hopper.

Same modules and class names as the JAX package; parameters carry the
rosinality state-dict keys, so a `g_ema` loads with `load_state_dict(strict=True)`.
The path covered so far: rosinality `.pt` checkpoint -> StyleGAN2 `Generator`
-> streaming `render()`. The fused bias + leaky-ReLU runs as a hand-written
CUDA kernel (csrc/fused_bias_act.cu) on CUDA tensors.

  ops/       fused bias + leaky-ReLU (kernel + plain form), upfirdn2d, kernel build
  models/    StyleGAN2 Generator and its blocks
  io/        rosinality checkpoint loading, weights carried across from maua_tpu
  reactive/  Bend and Rewrite records
  render/    render() and the video writers

Entry points: `maua_tpu_torch.io.load_generator(path, device=...)` and
`maua_tpu_torch.render.render(generator, None, latents, noise, out, device=...)`.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
