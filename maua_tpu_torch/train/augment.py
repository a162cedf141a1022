"""ADA, adaptive discriminator augmentation (counterpart of
maua_tpu/train/augment.py).

Per-sample random affine matrices (flip, quarter turns, integer translate,
isotropic and anisotropic log-normal scale, pre- and post-rotation with
p_rot = 1 - sqrt(1 - p), fractional translate) and colour matrices
(brightness, contrast, luma flip, hue rotation, saturation in 4-D homogeneous
colour space), applied with 2x SYM6-oversampled resampling, and the
adaptive-p update.

Random draws are kept apart from the arithmetic: `draw_augment` makes every
raw variate of a batch from a `torch.Generator` on the device
(`AugmentDraw`), and `augment_params` assembles the matrices from them and
the probability p (a 0-d tensor, so that an adaptive p stays on the device).
The tests hand the assembly the JAX package's own variates.

`apply_affine` has the JAX package's three methods: "conv" (reflect pad,
upfirdn2d up 2x through the flipped SYM6 taps, bilinear gather, upfirdn2d
down 2x), "matmul" (the same resampling as separable band matrices, and the
1x-grid `oversample_grid=False` mode) and "fft" (`train/fft_warp.py`).
`method=None` picks "conv" for a CPU tensor and "matmul" for a CUDA one. The
gather is the port's one plain bilinear gather (`ops/gather.py`); the JAX
package's packed and folded gathers with their custom VJPs exist for the
TPU's gather issue rate and are not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..audio.dsp import pad_axis
from ..device import DeviceLike, resolve_device
from ..ops.gather import bilinear_gather
from ..ops.upfirdn2d import upfirdn2d

__all__ = [
    "AffineDraw",
    "AugmentDraw",
    "AugmentParams",
    "ColorDraw",
    "SYM6",
    "ada_adjust_p",
    "affine_from_draw",
    "apply_affine",
    "apply_color",
    "augment",
    "augment_params",
    "color_from_draw",
    "draw_augment",
    "inv3",
]

# 12-tap SYM6 wavelet, the antialiasing filter
SYM6 = (
    0.015404109327027373,
    0.0034907120842174702,
    -0.11799011114819057,
    -0.048311742585633,
    0.4910559419267466,
    0.787641141030194,
    0.3379294217276218,
    -0.07263752278646252,
    -0.021060292512300564,
    0.04472490177066578,
    0.0017677118642428036,
    -0.007800708325034148,
)

_LUMA_AXIS = np.array([1.0, 1.0, 1.0, 0.0]) / math.sqrt(3.0)


# ---------------------------------------------------------------- matrices
def _eye(b: int, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=torch.float32, device=like.device).expand(b, n, n).clone()


def _translate_mat(t_x: torch.Tensor, t_y: torch.Tensor) -> torch.Tensor:
    m = _eye(t_x.shape[0], 3, t_x)
    m[:, 0, 2], m[:, 1, 2] = t_x, t_y
    return m


def _rotate_mat(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    m = _eye(theta.shape[0], 3, theta)
    m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1] = c, -s, s, c
    return m


def _scale_mat(s_x: torch.Tensor, s_y: torch.Tensor) -> torch.Tensor:
    m = _eye(s_x.shape[0], 3, s_x)
    m[:, 0, 0], m[:, 1, 1] = s_x, s_y
    return m


def _translate3d_mat(t: torch.Tensor) -> torch.Tensor:
    m = _eye(t.shape[0], 4, t)
    m[:, 0, 3], m[:, 1, 3], m[:, 2, 3] = t, t, t
    return m


def _scale3d_mat(s: torch.Tensor) -> torch.Tensor:
    m = _eye(s.shape[0], 4, s)
    m[:, 0, 0], m[:, 1, 1], m[:, 2, 2] = s, s, s
    return m


def _luma_outer(like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.outer(_LUMA_AXIS, _LUMA_AXIS).astype(np.float32)).to(like.device)


def _luma_flip_mat(i: torch.Tensor) -> torch.Tensor:
    return _eye(i.shape[0], 4, i) - 2.0 * _luma_outer(i)[None] * i[:, None, None]


def _saturation_mat(i: torch.Tensor) -> torch.Tensor:
    axis = _luma_outer(i)[None]
    return axis + (_eye(i.shape[0], 4, i) - axis) * i[:, None, None]


def _rotate3d_mat(theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about the luma axis."""
    u = _LUMA_AXIS[:3]
    consts = np.stack([np.eye(3), np.array([[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]]), np.outer(u, u)])
    eye3, cross, outer = torch.from_numpy(consts.astype(np.float32)).to(theta.device)
    s = torch.sin(theta)[:, None, None]
    c = torch.cos(theta)[:, None, None]
    m = _eye(theta.shape[0], 4, theta)
    m[:, :3, :3] = c * eye3[None] + s * cross[None] + (1 - c) * outer[None]
    return m


def _random_apply(u: torch.Tensor, p: torch.Tensor, mat: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """mat @ prev where u < p (u [B] uniform in [0, 1)), else prev."""
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)[None]
    select = (u < p).to(mat.dtype)[:, None, None]
    return (select * mat + (1 - select) * eye) @ prev


# ---------------------------------------------------------------- draws
class AffineDraw(NamedTuple):
    """Raw variates of `batch` affine matrices, each [B] fp32: `flip` 0/1
    (Bernoulli 0.5), `quarter` 0 or 3 quarter turns, `t` uniform in
    [-0.125, 0.125), `s` and `s2` unit normal, `th_pre` and `th_post` uniform
    in [-pi, pi), `tf` unit normal; `u` [8, B] uniform in [0, 1), whether
    each of the 8 elementary transforms applies (u < p, or p_rot for the
    rotations)."""

    flip: torch.Tensor
    quarter: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    th_pre: torch.Tensor
    s2: torch.Tensor
    th_post: torch.Tensor
    tf: torch.Tensor
    u: torch.Tensor


class ColorDraw(NamedTuple):
    """Raw variates of `batch` colour matrices, each [B] fp32: `b`, `c`, `sat`
    unit normal, `lf` 0/1 (Bernoulli 0.5), `hue` uniform in [-pi, pi); `u`
    [5, B] uniform in [0, 1)."""

    b: torch.Tensor
    c: torch.Tensor
    lf: torch.Tensor
    hue: torch.Tensor
    sat: torch.Tensor
    u: torch.Tensor


class AugmentDraw(NamedTuple):
    affine: AffineDraw
    color: ColorDraw


class AugmentParams(NamedTuple):
    """Sampled per-batch transform matrices."""

    affine: torch.Tensor  # [B, 3, 3]
    color: torch.Tensor  # [B, 4, 4]


def draw_augment(batch: int, generator: torch.Generator, device: DeviceLike = None) -> AugmentDraw:
    """Every raw variate of one augmentation of `batch` images, from
    `generator` (a torch.Generator on `device`)."""
    device = resolve_device(device)

    def rand(n=None):
        return torch.rand((batch,) if n is None else (n, batch), generator=generator, device=device)

    def normal():
        return torch.randn((batch,), generator=generator, device=device)

    def uniform(lo, hi):
        return lo + (hi - lo) * rand()

    affine = AffineDraw(
        flip=(rand() < 0.5).float(),
        quarter=3.0 * torch.randint(0, 2, (batch,), generator=generator, device=device).float(),
        t=uniform(-0.125, 0.125),
        s=normal(),
        th_pre=uniform(-math.pi, math.pi),
        s2=normal(),
        th_post=uniform(-math.pi, math.pi),
        tf=normal(),
        u=rand(8),
    )
    color = ColorDraw(b=normal(), c=normal(), lf=(rand() < 0.5).float(), hue=uniform(-math.pi, math.pi),
                      sat=normal(), u=rand(5))
    return AugmentDraw(affine, color)


def affine_from_draw(d: AffineDraw, p: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Per-sample composed affine [B, 3, 3] in normalised [-1, 1] coordinates
    (maua_tpu/train/augment.py:142-184)."""
    p = torch.as_tensor(p, dtype=torch.float32, device=d.t.device)
    b = d.t.shape[0]
    G = _eye(b, 3, d.t)
    ones = torch.ones_like(d.t)
    G = _random_apply(d.u[0], p, _scale_mat(1.0 - 2.0 * d.flip, ones), G)
    G = _random_apply(d.u[1], p, _rotate_mat(-math.pi / 2 * d.quarter), G)
    t_h = torch.round(d.t * height) / height
    t_w = torch.round(d.t * width) / width
    G = _random_apply(d.u[2], p, _translate_mat(t_w, t_h), G)
    s = torch.exp(d.s * (0.2 * math.log(2.0)))
    G = _random_apply(d.u[3], p, _scale_mat(s, s), G)
    p_rot = 1.0 - torch.sqrt(torch.clamp(1.0 - p, 0.0, 1.0))
    G = _random_apply(d.u[4], p_rot, _rotate_mat(-d.th_pre), G)
    s2 = torch.exp(d.s2 * (0.2 * math.log(2.0)))
    G = _random_apply(d.u[5], p, _scale_mat(s2, 1.0 / s2), G)
    G = _random_apply(d.u[6], p_rot, _rotate_mat(-d.th_post), G)
    tf = d.tf * 0.125
    return _random_apply(d.u[7], p, _translate_mat(tf, tf), G)


def color_from_draw(d: ColorDraw, p: torch.Tensor) -> torch.Tensor:
    """Per-sample composed colour matrix [B, 4, 4]
    (maua_tpu/train/augment.py:187-208)."""
    p = torch.as_tensor(p, dtype=torch.float32, device=d.b.device)
    C = _eye(d.b.shape[0], 4, d.b)
    C = _random_apply(d.u[0], p, _translate3d_mat(d.b * 0.2), C)
    C = _random_apply(d.u[1], p, _scale3d_mat(torch.exp(d.c * (0.5 * math.log(2.0)))), C)
    C = _random_apply(d.u[2], p, _luma_flip_mat(d.lf), C)
    C = _random_apply(d.u[3], p, _rotate3d_mat(d.hue), C)
    return _random_apply(d.u[4], p, _saturation_mat(torch.exp(d.sat * math.log(2.0))), C)


def augment_params(draw: AugmentDraw, p: torch.Tensor, height: int, width: int) -> AugmentParams:
    return AugmentParams(affine_from_draw(draw.affine, p, height, width), color_from_draw(draw.color, p))


# ---------------------------------------------------------------- application
def inv3(G: torch.Tensor) -> torch.Tensor:
    """Inverse of [B, 3, 3] matrices by the adjugate, elementwise in fp32:
    the same bits on every device (a batched LU differs between LAPACK and
    the card in the last bits)."""
    G = G.float()
    a, b, c = G[:, 0, 0], G[:, 0, 1], G[:, 0, 2]
    d, e, f = G[:, 1, 0], G[:, 1, 1], G[:, 1, 2]
    g, h, i = G[:, 2, 0], G[:, 2, 1], G[:, 2, 2]
    adj = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], 1)
    det = a * adj[:, 0, 0] + b * adj[:, 1, 0] + c * adj[:, 2, 0]
    return adj / det[:, None, None]


def _upfirdn1d_matrix(n_in: int, taps: torch.Tensor, up: int, down: int, pad0: int, pad1: int) -> torch.Tensor:
    """1-D upfirdn as a banded [n_out, n_in] matrix: output o takes input j
    through tap t = pad0 + up*j - down*o when 0 <= t < K, true convolution:
    M[o, j] = k[K - 1 - t]."""
    K = taps.shape[0]
    n_out = (n_in * up + pad0 + pad1 - K) // down + 1
    o = torch.arange(n_out, device=taps.device)[:, None]
    j = torch.arange(n_in, device=taps.device)[None, :]
    t = pad0 + up * j - down * o
    valid = (t >= 0) & (t < K)
    return torch.where(valid, taps[torch.clamp(K - 1 - t, 0, K - 1)], torch.zeros((), device=taps.device))


def _resample_sep(img3: torch.Tensor, M_h: torch.Tensor, M_w: torch.Tensor) -> torch.Tensor:
    """Separable resample of [R, H, W] maps: M_h @ img @ M_w^T."""
    tmp = torch.einsum("oh,rhw->row", M_h.to(img3.dtype), img3)
    return torch.einsum("row,pw->rop", tmp, M_w.to(img3.dtype))


def _reflect_pad(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    return pad_axis(pad_axis(x, -2, before, after, "reflect"), -1, before, after, "reflect")


def apply_affine(
    img: torch.Tensor,
    G: torch.Tensor,
    pad_frac: float = 0.25,
    method: Optional[str] = None,
    oversample_grid: bool = True,
    fft_taper: Optional[float] = 0.85,
    fft_taper_conditional: bool = True,
) -> torch.Tensor:
    """Resample img [B, C, H, W] through the per-sample affine G [B, 3, 3]
    (maua_tpu/train/augment.py:573-678): reflect-pad by a fixed margin,
    upsample 2x, bilinear-gather at G^-1-mapped coordinates, downsample 2x,
    crop. method: "conv", "matmul", "fft" (square images; the 1x-grid
    semantics, `oversample_grid` ignored) or None ("conv" on the CPU,
    "matmul" on CUDA). conv and matmul give the same values.
    oversample_grid=False (matmul only) samples at the 1x output grid and
    skips the decimation filter."""
    if method is None:
        method = "matmul" if img.is_cuda else "conv"
    if method == "fft":
        from .fft_warp import affine_warp_fft

        return affine_warp_fft(img, G, pad_frac=pad_frac, taper_from=fft_taper, taper_conditional=fft_taper_conditional)
    if method not in ("conv", "matmul"):
        raise ValueError(f"unknown warp method {method!r}")
    if not oversample_grid and method != "matmul":
        raise NotImplementedError("oversample_grid=False requires method='matmul'")
    b, c, h, w = img.shape
    dev = img.device
    k = torch.tensor(SYM6, dtype=torch.float32, device=dev)
    len_k = len(SYM6)
    pad = int(math.ceil(max(h, w) * pad_frac)) + (len_k + 1) // 2
    p_up = p_dn = len_k - 2
    up_pad = ((p_up + 1) // 2 + 1, p_up // 2)
    dn_pad = ((p_dn + 1) // 2, p_dn // 2)

    # output pixel grid (2x density by default) in normalised coordinates of
    # the unpadded image, mapped through G^-1 into the padded 2x source
    s_grid = 2 if oversample_grid else 1
    Ginv = inv3(G)
    ys = (torch.arange(s_grid * h, device=dev, dtype=torch.float32) + 0.5) / (s_grid * h) * 2.0 - 1.0
    xs = (torch.arange(s_grid * w, device=dev, dtype=torch.float32) + 0.5) / (s_grid * w) * 2.0 - 1.0
    gx, gy = (g[None] for g in torch.meshgrid(xs, ys, indexing="xy"))
    # elementwise, in a fixed order: the same coordinates on every device (a
    # last-bit difference at |px| ~ 600 moves a sample of a noisy image by 1e-4)
    m = Ginv[:, :2, :, None, None]
    px = ((m[:, 0, 0] * gx + m[:, 0, 1] * gy + m[:, 0, 2]) + 1.0) * w + 2.0 * pad - 0.5
    py = ((m[:, 1, 0] * gx + m[:, 1, 1] * gy + m[:, 1, 2]) + 1.0) * h + 2.0 * pad - 0.5

    if method == "matmul":
        imgf = _reflect_pad(img.reshape(b * c, h, w), pad, pad)
        kr = torch.flip(k, (0,))  # outer(kr, kr) is the flipped 2-D filter
        M_up_h = _upfirdn1d_matrix(h + 2 * pad, kr, 2, 1, *up_pad)
        M_up_w = _upfirdn1d_matrix(w + 2 * pad, kr, 2, 1, *up_pad)
        img2x = _resample_sep(imgf, M_up_h, M_up_w)
        sampled = bilinear_gather(img2x.reshape(b, c, *img2x.shape[1:]), px, py).reshape(b * c, *px.shape[1:])
        if not oversample_grid:
            # the up cascade's DC gain is 1/2 (zero-stuffing halves the mean,
            # the raw taps sum to sqrt 2 per axis); the skipped decimation
            # filter would have restored it
            return (2.0 * sampled).reshape(b, c, *sampled.shape[1:])[:, :, :h, :w]
        M_dn_h = _upfirdn1d_matrix(sampled.shape[1], k, 1, 2, *dn_pad)
        M_dn_w = _upfirdn1d_matrix(sampled.shape[2], k, 1, 2, *dn_pad)
        out = _resample_sep(sampled, M_dn_h, M_dn_w)
        return out.reshape(b, c, *out.shape[1:])[:, :, :h, :w]

    k2 = torch.outer(k, k)
    img_pad = _reflect_pad(img, pad, pad)
    # the raw SYM6 taps sum to sqrt 2 per axis: the up (gain 1/2) and down
    # (gain 2) passes together preserve amplitude
    img2x = upfirdn2d(img_pad, torch.flip(k2, (0, 1)), up=2, pad=up_pad)
    sampled = bilinear_gather(img2x, px, py)
    out = upfirdn2d(sampled, k2, down=2, pad=dn_pad)
    return out[:, :, :h, :w]


def apply_color(img: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """The homogeneous colour matrix C [B, 4, 4] applied per sample."""
    rgb = torch.einsum("bij,bjhw->bihw", C[:, :3, :3].to(img.dtype), img)
    return rgb + C[:, :3, 3][:, :, None, None].to(img.dtype)


def augment(
    img: torch.Tensor,
    p: torch.Tensor,
    draw: Optional[AugmentDraw] = None,
    params: Optional[AugmentParams] = None,
    fast_warp: bool = False,
    warp_method: Optional[str] = None,
    fft_taper: Optional[float] = 0.85,
    fft_taper_conditional: bool = True,
) -> tuple[torch.Tensor, AugmentParams]:
    """Affine, then colour. The matrices come from `params`, or are assembled
    from `draw` and p. fast_warp: the 1x-grid matmul warp; warp_method
    overrides the geometry path ("fft", "matmul", "conv")."""
    if params is None:
        if draw is None:
            raise ValueError("augment() needs a draw or params")
        params = augment_params(draw, p, img.shape[2], img.shape[3])
    method = warp_method if warp_method else ("matmul" if fast_warp else None)
    out = apply_affine(img, params.affine, method=method, oversample_grid=not fast_warp,
                       fft_taper=fft_taper, fft_taper_conditional=fft_taper_conditional)
    return apply_color(out, params.color), params


def ada_adjust_p(
    ada_p: torch.Tensor,
    signs_sum: torch.Tensor,
    n_pred: torch.Tensor,
    target: float = 0.6,
    length: float = 15_000.0,
    threshold: float = 256.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adaptive p (maua_tpu/train/augment.py:732-758): once more than
    `threshold` real predictions are counted, step p by +-(target / length)
    * n towards r_t = target and reset the counts. 0-d fp32 tensors in and
    out, no host sync. Returns (p, signs_sum, n_pred, r_t)."""
    zero = torch.zeros_like(ada_p)
    r_t = torch.where(n_pred > 0, signs_sum / torch.clamp(n_pred, min=1.0), zero)
    do_update = n_pred > threshold
    step = torch.tensor(target / length, dtype=torch.float32, device=ada_p.device)
    sign = torch.where(r_t > target, 1.0, -1.0)
    new_p = torch.clamp(ada_p + sign * step * n_pred, 0.0, 1.0)
    return (
        torch.where(do_update, new_p, ada_p),
        torch.where(do_update, zero, signs_sum),
        torch.where(do_update, zero, n_pred),
        r_t,
    )
