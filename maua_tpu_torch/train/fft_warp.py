"""Gather-free affine warp for ADA: FFT row shears and banded-matrix scales
(counterpart of maua_tpu/train/fft_warp.py).

An affine warp factors into two 1-D passes (Catmull & Smith 1980); each pass
is a shear, a per-row translation done exactly as a phase ramp on the row's
rFFT (periodic-sinc interpolation), then a per-sample uniform 1-D scale, a
banded [out, in] matrix shared by all rows (one batched matmul). All of it
is dense, so the backward is dense too.

Semantics, as in the JAX package: the reflect-padded source of
`apply_affine(method="matmul", oversample_grid=False)`, zeros outside the
pad (wrap masks after each shear), the 1x output grid; the shear
interpolates with a periodic sinc and the scale with a minification-widened
tent, so values differ from the gather path at interpolation level, while
lattice transforms (identity, flips, quarter turns, integer translates) are
exact. A per-sample transpose keeps the first shear's slope at most 1, and
an identity G passes its image through untouched.

`shear_impl`: "fft" is `torch.fft.rfft`/`irfft` (cuFFT on the card), always
in fp32; "dftmm" is the same transform as shared DFT matmuls (bf16 inputs
stay bf16 in the matmuls, which accumulate and return fp32), the JAX
package's TPU fast path, kept for its tests and for comparison; "auto" is
"fft" on every device (the TPU's FFT is what made dftmm pay there).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from ..audio.dsp import pad_axis
from .augment import inv3

__all__ = ["affine_warp_fft", "next_smooth"]


def next_smooth(n: int) -> int:
    """Smallest {2, 3, 5}-smooth integer >= n (fast FFT lengths)."""
    m = n
    while True:
        k = m
        for f in (2, 3, 5):
            while k % f == 0:
                k //= f
        if k == 1:
            return m
        m += 1


@lru_cache(maxsize=8)
def _dft_mats(n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Real rDFT / irDFT as dense fp32 matrices: Re = x @ cos_f, Im =
    -(x @ sin_f), cos_f and sin_f [n, n // 2 + 1]; the inverse is
    (Re w) @ cos_f^T - (Im w) @ sin_f^T with the hermitian weights w."""
    k = np.arange(n // 2 + 1, dtype=np.float64)
    j = np.arange(n, dtype=np.float64)
    ang = (2.0 * np.pi / n) * np.outer(j, k)
    w = np.full(n // 2 + 1, 2.0 / n)
    w[0] = 1.0 / n
    if n % 2 == 0:
        w[-1] = 1.0 / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32), w.astype(np.float32)


class _MatmulF32(torch.autograd.Function):
    """a @ b of bf16 CUDA matrices with an fp32 result (cuBLAS's bf16
    products, fp32 accumulation, no rounding of the output); the gradients
    in fp32, cast to the operands' dtypes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = (g @ b.float().t()).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = (a.float().t() @ g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., n] @ b [n, m] with an fp32 result: bf16 operands are
    multiplied as they are and accumulated in fp32."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if a.dtype == torch.float32:
        out = a2 @ b
    elif a.is_cuda:
        out = _MatmulF32.apply(a2, b)
    else:  # the products of bf16 values are exact in fp32
        out = a2.float() @ b.float()
    return out.reshape(*lead, b.shape[-1])


def _taper(k: torch.Tensor, n: int, s: torch.Tensor, taper_from: float, taper_conditional: bool) -> torch.Tensor:
    """Raised-cosine band taper from `taper_from` x Nyquist; with
    `taper_conditional`, only rows whose shift s is fractional are tapered."""
    fr = k / (n / 2.0)
    t = torch.where(
        fr <= taper_from,
        torch.ones_like(fr),
        0.5 * (1.0 + torch.cos(math.pi * (fr - taper_from) / max(1.0 - taper_from, 1e-6))),
    )
    if taper_conditional:
        has_frac = torch.abs(s - torch.round(s)) > 1e-4
        t = torch.where(has_frac, t, torch.ones_like(t))
    return t


def _phase(n: int, shift: torch.Tensor, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(k, s, angle): bins 0..n/2, the shift folded mod n [..., 1], and
    2 pi k s / n."""
    k = torch.arange(n // 2 + 1, dtype=torch.float32, device=device)
    s = torch.remainder(shift.float(), float(n))[..., None]
    return k, s, (2.0 * math.pi / n) * k * s


def _shift_rows_dftmm(x, shift, taper_from: Optional[float], taper_conditional: bool) -> torch.Tensor:
    n = x.shape[-1]
    cos_f, sin_f, w = _dft_mats(n)
    bf16 = x.dtype == torch.bfloat16
    mdt = torch.bfloat16 if bf16 else torch.float32
    cos_m = torch.from_numpy(cos_f).to(x.device, mdt)
    sin_m = torch.from_numpy(sin_f).to(x.device, mdt)
    xm = x.to(mdt)
    re = _mm_f32(xm, cos_m)
    im = -_mm_f32(xm, sin_m)
    k, s, ang = _phase(n, shift, x.device)
    c, sn = torch.cos(ang), torch.sin(ang)
    re, im = re * c - im * sn, re * sn + im * c
    if n % 2 == 0:  # the Nyquist bin of a real signal stays real
        im = torch.cat([im[..., :-1], torch.zeros_like(im[..., -1:])], dim=-1)
    if taper_from is not None:
        t = _taper(k, n, s, taper_from, taper_conditional)
        re, im = re * t, im * t
    wk = torch.from_numpy(w).to(x.device)
    out = _mm_f32((re * wk).to(mdt), cos_m.t()) - _mm_f32((im * wk).to(mdt), sin_m.t())
    return out.to(x.dtype) if bf16 else out


def _fft_shift_rows(x, shift, taper_from: Optional[float], taper_conditional: bool = True, impl: str = "fft") -> torch.Tensor:
    """Shift each row of x [..., n] left by `shift` samples (broadcast over
    x's leading dims): out[..., i] = x_interp[..., i + shift], by an rFFT
    phase ramp. Wrapped-around content is not masked here. The optional
    taper suppresses the periodic sinc's ringing at the top of the band;
    conditional, it spares rows with integer shifts, which are exact
    relabellings. fp32 out for "fft"; "dftmm" returns bf16 for bf16 x."""
    if impl == "dftmm":
        return _shift_rows_dftmm(x, shift, taper_from, taper_conditional)
    n = x.shape[-1]
    f = torch.fft.rfft(x.float().reshape(-1, n), dim=-1).reshape(*x.shape[:-1], n // 2 + 1)
    k, s, ang = _phase(n, shift, x.device)
    f = f * torch.polar(torch.ones_like(ang), ang)
    if n % 2 == 0:  # the Nyquist bin of a real signal stays real under a fractional shift
        f = torch.cat([f[..., :-1], torch.complex(f[..., -1:].real, torch.zeros_like(f[..., -1:].real))], dim=-1)
    if taper_from is not None:
        f = f * _taper(k, n, s, taper_from, taper_conditional)
    return torch.fft.irfft(f.reshape(-1, f.shape[-1]), n=n, dim=-1).reshape(*f.shape[:-1], n)


def _scale_band(n_out: int, n_in: int, sigma: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Per-sample banded resample matrix [B, n_out, n_in]: a tent of width
    w = max(|sigma|, 1) at sigma * o + gamma, rows renormalised in the interior
    and ramping to zero at the edges."""
    o = torch.arange(n_out, dtype=torch.float32, device=sigma.device)
    i = torch.arange(n_in, dtype=torch.float32, device=sigma.device)
    pos = sigma[:, None] * o[None, :] + gamma[:, None]
    w = torch.clamp(torch.abs(sigma), min=1.0)[:, None, None]
    z = (i[None, None, :] - pos[:, :, None]) / w
    k = torch.clamp(1.0 - torch.abs(z), min=0.0) / w
    rn = torch.sum(k, dim=-1, keepdim=True)
    return k * (torch.clamp(rn, max=1.0) / torch.clamp(rn, min=1e-6))


def _wrap_mask(n: int, shift: torch.Tensor) -> torch.Tensor:
    """Validity of a row shifted left by `shift`: sample i reads m = i +
    shift, valid on [0, n - 1] with a 1-px ramp to zero at -1 and n."""
    i = torch.arange(n, dtype=torch.float32, device=shift.device)
    m = i + shift.float()[..., None]
    return torch.clamp(m + 1.0, 0.0, 1.0) * torch.clamp(float(n) - m, 0.0, 1.0)


def affine_warp_fft(
    img: torch.Tensor,
    G: torch.Tensor,
    pad_frac: float = 0.25,
    taper_from: Optional[float] = 0.85,
    taper_conditional: bool = True,
    shear_impl: str = "auto",
) -> torch.Tensor:
    """Warp img [B, C, H, H] through the normalised-coordinate affine G
    [B, 3, 3] (maua_tpu/train/fft_warp.py:234-347). The transform's
    parameters get no gradient; the image's does."""
    b, c, h, w = img.shape
    if h != w:
        raise ValueError(f"affine_warp_fft needs square images, got {h}x{w}")
    if shear_impl == "auto":
        shear_impl = "fft"
    if shear_impl not in ("fft", "dftmm"):
        raise ValueError(f"unknown shear_impl {shear_impl!r}")

    pad_min = math.ceil(h * pad_frac) + 1
    hp = next_smooth(h + 2 * pad_min)
    pad = (hp - h) // 2
    pad2 = hp - h - pad
    imgp = pad_axis(pad_axis(img, -2, pad, pad2, "reflect"), -1, pad, pad2, "reflect")

    # pixel-space affine of the padded source: p = A (x', y') + t
    G = G.detach().float()
    Ginv = inv3(G)
    A = Ginv[:, :2, :2]
    half = 0.5 * (1.0 - float(h))
    tx = (A[:, 0, 0] + A[:, 0, 1]) * half + (Ginv[:, 0, 2] + 1.0) * (h / 2.0) + pad - 0.5
    ty = (A[:, 1, 0] + A[:, 1, 1]) * half + (Ginv[:, 1, 2] + 1.0) * (h / 2.0) + pad - 0.5

    # per-sample transpose where |b| > |d|, so that the first shear's slope is at most 1
    sel = torch.abs(A[:, 0, 1]) > torch.abs(A[:, 1, 1])
    a_ = torch.where(sel, A[:, 1, 0], A[:, 0, 0])
    b_ = torch.where(sel, A[:, 1, 1], A[:, 0, 1])
    c_ = torch.where(sel, A[:, 0, 0], A[:, 1, 0])
    d_ = torch.where(sel, A[:, 0, 1], A[:, 1, 1])
    tx_ = torch.where(sel, ty, tx)
    ty_ = torch.where(sel, tx, ty)
    src = torch.where(sel[:, None, None, None], imgp.transpose(-1, -2), imgp)

    d_safe = torch.where(torch.abs(d_) < 1e-3, torch.where(d_ < 0, -1e-3, 1e-3), d_)
    det = a_ * d_ - b_ * c_

    # pass 1, rows: T[v, x'] = src[v, sigma1 x' + beta1 v + delta1]; the band
    # matrix is centred on an integer, so sigma = +-1 has exact taps and the
    # fractional rest rides the exact FFT shear
    sigma1 = det / d_safe
    beta1 = b_ / d_safe
    delta1 = tx_ - beta1 * ty_
    gamma1 = torch.round((hp - sigma1 * (w - 1)) / 2.0)
    v_idx = torch.arange(hp, dtype=torch.float32, device=img.device)
    s1 = beta1[:, None] * v_idx[None, :] + (delta1 - gamma1)[:, None]
    sheared = _fft_shift_rows(src, s1[:, None, :], taper_from, taper_conditional, shear_impl)
    sheared = sheared * _wrap_mask(hp, s1)[:, None, :, :].to(sheared.dtype)
    K1 = _scale_band(w, hp, sigma1, gamma1).to(sheared.dtype)
    T = torch.einsum("bchx,box->bcho", sheared, K1)

    # pass 2, columns: out[y', x'] = T[sigma2 y' + beta2 x' + delta2, x']
    sigma2, beta2, delta2 = d_, c_, ty_
    gamma2 = torch.round((hp - sigma2 * (h - 1)) / 2.0)
    x_idx = torch.arange(w, dtype=torch.float32, device=img.device)
    s2 = beta2[:, None] * x_idx[None, :] + (delta2 - gamma2)[:, None]
    sheared2 = _fft_shift_rows(T.transpose(-1, -2), s2[:, None, :], taper_from, taper_conditional, shear_impl)
    sheared2 = sheared2 * _wrap_mask(hp, s2)[:, None, :, :].to(sheared2.dtype)
    K2 = _scale_band(h, hp, sigma2, gamma2).to(sheared2.dtype)
    out = torch.einsum("bcxv,byv->bcxy", sheared2, K2).transpose(-1, -2).to(img.dtype)

    # an identity G passes its image through bit-exact (ADA's warm-up, p ~ 0)
    is_ident = torch.all(torch.abs(G - torch.eye(3, device=G.device)) < 1e-6, dim=2).all(dim=1)
    return torch.where(is_ident[:, None, None, None], img, out)
