"""Causal multi-head attention, plain PyTorch.

These are the plain versions of the port's attention kernels
(ops/kernels/flash_attention.py, ops/kernels/packed_attention.py with its
backward, ops/kernels/decode_attention.py): the kernel wrappers run them
for CPU tensors, and the tests and chip_smoke.py hold the kernels against
them. Semantics of coati_tpu/ops/attention.py:
scores scaled by 1/sqrt(Dh), causal or position mask, softmax, probs @ v.
Layouts: q/k/v (B, T, H, Dh); decode query (B, H, Dh); caches
(B, T, H, Dh); int8 scales (B, T, H). The decode forms with per-row
positions at the end (ragged, ring) serve the continuous-batching engine
and have no kernel.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free
# bytes one (chunk, H, T, T) float32 tensor of the backward may take
BACKWARD_CHUNK_BYTES = 256 * 2**20


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


def causal_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    chunk_bytes: int = BACKWARD_CHUNK_BYTES,
):
    """(dq, dk, dv) of causal_attention with a float32 softmax, given the
    cotangent g of its output; all (B, T, H, Dh), results in the inputs'
    dtypes. The explicit formula of coati_tpu's packed backward kernel
    (ops/pallas/packed_attention.py, _packed_bwd_kernel), with its rounding
    points:

        P  = softmax(q k^T / sqrt(Dh) + causal mask)       float32
        dP = g v^T                                          float32
        dS = P * (dP - rowsum(P * dP)) / sqrt(Dh)           -> q's dtype
        dq = dS k,  dk = dS^T q,  dv = P^T g  (P -> g's dtype)

    with g cast to q's dtype first and every product accumulated in
    float32. The probabilities are recomputed, not saved. It walks the
    batch in chunks so that no (chunk, H, T, T) float32 tensor exceeds
    chunk_bytes."""
    b, t, h, dh = q.shape
    g = g.to(q.dtype)
    scale = 1.0 / math.sqrt(dh)
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    chunk = max(1, chunk_bytes // (4 * h * t * t))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for s in range(0, b, chunk):
        r = slice(s, s + chunk)
        qc, kc, vc, gc = q[r], k[r], v[r], g[r]
        scores = torch.einsum("bthd,bshd->bhts", qc.float(), kc.float()) * scale
        p = torch.softmax(scores.masked_fill(~causal, _NEG_INF), dim=-1)
        dp = torch.einsum("bthd,bshd->bhts", gc.float(), vc.float())
        pdp = p * dp
        ds = ((pdp - p * pdp.sum(dim=-1, keepdim=True)) * scale).to(q.dtype)
        dq[r] = torch.einsum("bhts,bshd->bthd", ds, kc)
        dk[r] = torch.einsum("bhts,bthd->bshd", ds, qc)
        dv[r] = torch.einsum("bhts,bthd->bshd", p.to(g.dtype), gc)
    return dq, dk, dv


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


# ------------------------------------------- per-row positions (serving)
#
# The continuous-batching engine (serving/continuous.py) decodes rows that
# sit at different depths. These are plain PyTorch in the port as in
# coati_tpu, where XLA computed them and no Pallas kernel did.


def _scores_f32(q1, k_cache):
    dh = q1.shape[-1]
    return torch.einsum("bhd,bshd->bhs", q1, k_cache).float() * (1.0 / math.sqrt(dh))


def _quant_scores(q1, k_data, k_scale):
    dh = q1.shape[-1]
    scores = torch.einsum("bhd,bshd->bhs", q1.float(), k_data.float())
    return scores * k_scale.float().transpose(1, 2) * (1.0 / math.sqrt(dh))


def _masked_read(scores, valid, v_cache):
    """softmax over the (B, T) valid slots of scores (B, H, T), then the
    probabilities against v_cache (B, T, H, Dh)."""
    probs = torch.softmax(scores.masked_fill(~valid[:, None, :], _NEG_INF), dim=-1)
    return torch.einsum("bhs,bshd->bhd", probs.to(v_cache.dtype), v_cache)


def _masked_read_quant(scores, valid, v_data, v_scale, out_dtype):
    probs = torch.softmax(scores.masked_fill(~valid[:, None, :], _NEG_INF), dim=-1)
    probs = probs * v_scale.float().transpose(1, 2)
    return torch.einsum("bhs,bshd->bhd", probs, v_data.float()).to(out_dtype)


def _ragged_valid(t_max: int, pos: torch.Tensor) -> torch.Tensor:
    return torch.arange(t_max, device=pos.device)[None, :] <= pos[:, None]


def decode_attention_ragged(
    q1: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor
) -> torch.Tensor:
    """decode_attention with per-row positions: row b attends over
    [0, pos[b]]. pos: (B,) integer tensor. Same as decode_attention when
    pos is constant across rows."""
    return _masked_read(_scores_f32(q1, k_cache), _ragged_valid(k_cache.shape[1], pos), v_cache)


def decode_attention_quant_ragged(
    q1: torch.Tensor,
    k_data: torch.Tensor,  # (B, T, H, Dh) int8
    k_scale: torch.Tensor,  # (B, T, H)
    v_data: torch.Tensor,
    v_scale: torch.Tensor,
    pos: torch.Tensor,  # (B,) per-row positions
) -> torch.Tensor:
    """decode_attention_quant with per-row positions; the scales factor
    out as in the scalar-position form."""
    scores = _quant_scores(q1, k_data, k_scale)
    return _masked_read_quant(scores, _ragged_valid(k_data.shape[1], pos), v_data, v_scale,
                              q1.dtype)


def _ring_valid(ring_pos, lpos: torch.Tensor, t_max: int) -> torch.Tensor:
    """(B, T) mask of live ring slots: slot s holds the key of age
    (ring_pos - s) mod T; row b's history spans ages [0, lpos[b]]."""
    ages = torch.remainder(ring_pos - torch.arange(t_max, device=lpos.device), t_max)
    return ages[None, :] <= lpos[:, None]


def decode_attention_ring(
    q1: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    ring_pos,  # int: the slot just written (age 0)
    lpos: torch.Tensor,  # (B,) the current token's logical position
) -> torch.Tensor:
    """Ring-buffer decode attention of the continuous-batching engine:
    every row writes at the same ring slot per step, and a row's history is
    selected by age: slot s holds the key of age (ring_pos - s) mod T, row b
    attends ages [0, lpos[b]]. Equals decode_attention when the ring has not
    wrapped and positions are uniform. Needs every row's history shorter
    than T (the engine sizes the ring with a segment of slack)."""
    valid = _ring_valid(ring_pos, lpos, k_cache.shape[1])
    return _masked_read(_scores_f32(q1, k_cache), valid, v_cache)


def decode_attention_quant_ring(
    q1: torch.Tensor,
    k_data: torch.Tensor,  # (B, T, H, Dh) int8
    k_scale: torch.Tensor,  # (B, T, H)
    v_data: torch.Tensor,
    v_scale: torch.Tensor,
    ring_pos,
    lpos: torch.Tensor,
) -> torch.Tensor:
    """decode_attention_quant over a ring cache (see decode_attention_ring)."""
    scores = _quant_scores(q1, k_data, k_scale)
    return _masked_read_quant(scores, _ring_valid(ring_pos, lpos, k_data.shape[1]), v_data,
                              v_scale, q1.dtype)
