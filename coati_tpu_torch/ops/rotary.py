"""Rotary position embedding (RoPE), eq. (34) of arXiv:2104.09864.

Numerics of coati_tpu/ops/rotary.py: cos/sin = f(position) of shape
(n_seq, head_dim) from inv_freq = base^(-2i/head_dim) and
emb = concat(freqs, freqs), applied after the head split.
"""

from __future__ import annotations

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
