"""Rotary position embedding (RoPE), eq. (34) of arXiv:2104.09864.

Numerics of coati_tpu/ops/rotary.py: cos/sin = f(position) of shape
(n_seq, head_dim) from inv_freq = base^(-2i/head_dim) and
emb = concat(freqs, freqs), applied after the head split.
"""

from __future__ import annotations

import math

import torch


def rotary_tables(n_seq: int, head_dim: int, base: float = 10000.0, device=None):
    """Return (cos, sin), each (n_seq, head_dim), float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (base**exponent)
    t = torch.arange(n_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., T, head_dim); cos/sin: broadcastable (T, head_dim)."""
    return x * cos + rotate_half(x) * sin


# ------------------------------------------------------------------ YaRN
# DeepSeek-V2's rotary embedding (arXiv:2309.00071, as in its published
# modeling code): frequencies blended between the original and the
# interpolated ones over a ramp of dimensions, applied to the de-interleaved
# rope dims of each head.


def yarn_correction_dim(n_rot: float, dim: int, base: float, original: int) -> float:
    """The dimension whose wavelength turns `n_rot` times over `original`
    positions."""
    return dim * math.log(original / (n_rot * 2 * math.pi)) / (2 * math.log(base))


def yarn_correction_range(beta_fast: float, beta_slow: float, dim: int, base: float,
                          original: int) -> tuple:
    """(low, high): the ramp's ends, floored and ceiled, inside [0, dim - 1]."""
    low = math.floor(yarn_correction_dim(beta_fast, dim, base, original))
    high = math.ceil(yarn_correction_dim(beta_slow, dim, base, original))
    return max(low, 0), min(high, dim - 1)


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_tables(n_seq: int, dim: int, base: float, factor: float, original: int,
                beta_fast: float, beta_slow: float, mscale: float, mscale_all_dim: float,
                device=None):
    """(cos, sin), each (n_seq, dim), float32: cos/sin of concat(freqs,
    freqs) with inv_freq = f_inter * ramp + f_extra * (1 - ramp), times
    mscale(factor, mscale) / mscale(factor, mscale_all_dim)."""
    f_extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    f_inter = f_extra / factor
    low, high = yarn_correction_range(beta_fast, beta_slow, dim, base, original)
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    ramp = ((i - low) / max(high - low, 0.001)).clamp(0, 1)
    inv_freq = f_inter * ramp + f_extra * (1 - ramp)
    freqs = torch.outer(torch.arange(n_seq, dtype=torch.float32, device=device), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    scale = yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all_dim)
    return emb.cos() * scale, emb.sin() * scale


def apply_rotary_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V2's rope on pairs stored interleaved: each (..., dim) vector
    de-interleaved ([x0, x2, ..., x1, x3, ...]) then rotated by halves, in
    float32, back in x's dtype."""
    xf = x.float().unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    return apply_rotary(xf, cos.float(), sin.float()).to(x.dtype)
