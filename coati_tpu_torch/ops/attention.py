"""Causal multi-head attention, plain PyTorch.

These are the plain versions of the port's two attention kernels
(ops/kernels/flash_attention.py, ops/kernels/decode_attention.py): the
kernel wrappers run them for CPU tensors, and the tests and chip_smoke.py
hold the kernels against them. Semantics of coati_tpu/ops/attention.py:
scores scaled by 1/sqrt(Dh), causal or position mask, softmax, probs @ v.
Layouts: q/k/v (B, T, H, Dh); decode query (B, H, Dh); caches
(B, T, H, Dh); int8 scales (B, T, H).
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    softmax_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """q, k, v: (B, T, H, Dh) -> (B, T, H, Dh), causal.

    softmax_dtype float32 upcasts the scores for an exact softmax; the
    compute dtype (bf16) keeps the (B, H, T, T) probs in bf16, masked
    with -1e4 so the value stays in range."""
    _, t, _, dh = q.shape
    scores = torch.einsum("bthd,bshd->bhts", q, k)
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=softmax_dtype, device=q.device)
    scores = scores.to(softmax_dtype) * scale
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    neg = _NEG_INF if softmax_dtype == torch.float32 else -1e4
    scores = scores.masked_fill(~causal, neg)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _position_mask(t_max: int, pos: int, device) -> torch.Tensor:
    return torch.arange(t_max, device=device) <= pos


def decode_attention(
    q1: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int
) -> torch.Tensor:
    """Attend a single query position against the cache.

    q1: (B, H, Dh) — query at position `pos`.
    k_cache, v_cache: (B, Tmax, H, Dh) — positions > pos are masked out.
    pos: current position (attends over [0, pos]). Returns (B, H, Dh)."""
    dh = q1.shape[-1]
    scores = torch.einsum("bhd,bshd->bhs", q1, k_cache).float() * (1.0 / math.sqrt(dh))
    valid = _position_mask(k_cache.shape[1], pos, q1.device)
    scores = scores.masked_fill(~valid, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    return torch.einsum("bhs,bshd->bhd", probs, v_cache)


def decode_attention_quant(
    q1: torch.Tensor,
    k_data: torch.Tensor,  # (B, T, H, Dh) int8
    k_scale: torch.Tensor,  # (B, T, H) f32 or bf16
    v_data: torch.Tensor,
    v_scale: torch.Tensor,
    pos: int,
) -> torch.Tensor:
    """decode_attention over an int8-quantized cache. Per-token-per-head
    scales factor out of both contractions exactly:
        q . (k8 * ks) = (q . k8) * ks        (scores)
        sum_s p_s * (v8_s * vs_s) = sum_s (p_s * vs_s) * v8_s   (output)"""
    dh = q1.shape[-1]
    scores = torch.einsum("bhd,bshd->bhs", q1.float(), k_data.float())
    scores = scores * k_scale.float().transpose(1, 2) * (1.0 / math.sqrt(dh))
    valid = _position_mask(k_data.shape[1], pos, q1.device)
    scores = scores.masked_fill(~valid, _NEG_INF)
    probs = torch.softmax(scores, dim=-1) * v_scale.float().transpose(1, 2)
    return torch.einsum("bhs,bshd->bhd", probs, v_data.float()).to(q1.dtype)
