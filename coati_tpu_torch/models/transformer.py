"""Causal rotary SMILES transformer — the COATI encoder/decoder trunk.

PyTorch counterpart of coati_tpu/models/transformer.py: the full-sequence
forward (encode, and the training forward to logits), prefill into a KV
cache, and one decode step. The parameters live in `SmilesTransformer`, an nn.Module
whose state-dict keys are the reference RotarySmilesTransformer's
('emb.tok_emb.weight', 'transformer.h.{i}.attn.c_attn.weight', ...) with
weights in PyTorch's (out, in) layout; the functions below take it as
`params`, as the JAX functions take their parameter pytree.

Attention goes through the port's kernels: K2 (flash causal attention)
for every full-sequence pass, encode and prefill alike, or K5f (the
short-sequence kernel, T <= 128) under prefill_kernel="packed"; and K1
(masked read decode attention) for every decode step. Both full-sequence
wrappers are differentiable: K5f's backward is the kernel K5b, K2's replays
the plain attention. On CPU tensors the
kernel wrappers run their plain versions. The config fields
`prefill_kernel` and `decode_kernel` stay so documents load, but cannot
route around the kernels: their other TPU-era choices ("xla", "pallas",
"auto") all mean K2 and K1.

The KV cache is updated in place: prefill and decode_step write into the
cache they are given and return it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from coati_tpu_torch.ops.kernels.decode_attention import (
    decode_attention,
    decode_attention_quant,
)
from coati_tpu_torch.ops.kernels.flash_attention import flash_causal_attention
from coati_tpu_torch.ops.kernels.packed_attention import MAX_T as PACKED_MAX_T
from coati_tpu_torch.ops.kernels.packed_attention import packed_causal_attention
from coati_tpu_torch.ops.layers import cast_floats, gelu_tanh, layer_norm, linear
from coati_tpu_torch.ops.rotary import apply_rotary, rotary_tables

@dataclass(frozen=True)
class TransformerConfig:
    """Field names of coati_tpu's TransformerConfig, so stored configs load.
    `precision`, `topk_recall` and `softmax_dtype` have no effect here:
    float32 matmuls run in full float32, top-k is always exact, and the
    attention kernels always take the softmax in float32 (as the TPU's flash
    kernel did). `remat` recomputes each block in the backward pass
    (torch.utils.checkpoint) instead of keeping its activations."""

    n_layer: int = 4
    n_embd: int = 128
    n_head: int = 4
    n_seq: int = 256
    n_tok: int = 100
    biases: bool = True
    norm_embed: bool = False
    dtype: str = "float32"  # compute dtype: "float32" | "bfloat16"
    precision: str = "default"
    # KV-cache storage: "auto" (int8 under bfloat16, else the compute
    # dtype), "int8" or "compute"
    kv_dtype: str = "auto"
    kv_scale_dtype: str = "float32"  # int8-cache scales: "float32" | "bfloat16"
    decode_kernel: str = "xla"
    remat: bool = False
    softmax_dtype: str = "float32"
    prefill_kernel: str = "auto"
    topk_recall: float = 0.8

    def replace(self, **changes) -> "TransformerConfig":
        return dataclasses.replace(self, **changes)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def kv_quantized(self) -> bool:
        """Whether decode caches store int8 (see kv_dtype)."""
        if self.kv_dtype == "int8":
            return True
        if self.kv_dtype == "compute":
            return False
        if self.kv_dtype != "auto":
            raise ValueError(
                f"kv_dtype must be 'auto', 'int8' or 'compute', got {self.kv_dtype!r}"
            )
        return self.dtype == "bfloat16"

    @property
    def kv_scale_torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.kv_scale_dtype == "bfloat16" else torch.float32


# ------------------------------------------------------------ parameters


class _Attention(nn.Module):
    def __init__(self, d: int, biases: bool):
        super().__init__()
        self.c_attn = nn.Linear(d, 3 * d, bias=biases)
        self.c_proj = nn.Linear(d, d, bias=biases)


class Block(nn.Module):
    """One transformer block; keys 'ln_1', 'attn.c_attn', 'attn.c_proj',
    'ln_2', 'mlpf.0', 'mlpf.2' as in the reference."""

    def __init__(self, d: int, biases: bool):
        super().__init__()
        self.ln_1 = nn.LayerNorm(d)
        self.attn = _Attention(d, biases)
        self.ln_2 = nn.LayerNorm(d)
        self.mlpf = nn.Sequential(
            nn.Linear(d, 4 * d, bias=biases),
            nn.GELU(approximate="tanh"),
            nn.Linear(4 * d, d, bias=biases),
        )


class _Embedding(nn.Module):
    def __init__(self, n_tok: int, d: int, norm_embed: bool):
        super().__init__()
        emb = nn.Embedding(n_tok, d)
        self.tok_emb = nn.Sequential(emb, nn.LayerNorm(d)) if norm_embed else emb


class _Trunk(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.h = nn.ModuleList(Block(cfg.n_embd, cfg.biases) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd)


class SmilesTransformer(nn.Module):
    """Parameters of the trunk, under the reference's state-dict keys."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.emb = _Embedding(cfg.n_tok, cfg.n_embd, cfg.norm_embed)
        self.transformer = _Trunk(cfg)
        self.lm_head = nn.Linear(cfg.n_embd, cfg.n_tok, bias=False)

    def token_table(self):
        """(embedding weight, optional embedding LayerNorm)."""
        if isinstance(self.emb.tok_emb, nn.Sequential):
            return self.emb.tok_emb[0].weight, self.emb.tok_emb[1]
        return self.emb.tok_emb.weight, None


# ------------------------------------------------------------- routing


def _check_kernel_fields(cfg: TransformerConfig) -> None:
    if cfg.prefill_kernel not in ("auto", "xla", "pallas", "packed"):
        raise ValueError(
            f"prefill_kernel must be 'auto', 'xla', 'pallas' or 'packed', got "
            f"{cfg.prefill_kernel!r}"
        )
    if cfg.decode_kernel not in ("xla", "pallas"):
        raise ValueError(f"decode_kernel must be 'xla' or 'pallas', got {cfg.decode_kernel!r}")


def _full_attention(q, k, v, cfg: TransformerConfig) -> torch.Tensor:
    """Causal attention over a full sequence, (B, T, H, Dh) -> the same:
    K5f under prefill_kernel="packed", which refuses what that kernel does
    not serve, else K2."""
    if cfg.prefill_kernel == "packed":
        t = q.shape[1]
        if t > PACKED_MAX_T or cfg.n_head <= 1:
            raise ValueError(
                f"prefill_kernel='packed' needs T <= {PACKED_MAX_T} and n_head > 1, "
                f"got T={t}, n_head={cfg.n_head}"
            )
        return packed_causal_attention(q, k, v)
    return flash_causal_attention(q, k, v)


def _rotary(cfg: TransformerConfig, device: torch.device):
    """(cos, sin) tables in the compute dtype."""
    cos, sin = rotary_tables(cfg.n_seq, cfg.head_dim, device=device)
    return cos.to(cfg.compute_dtype), sin.to(cfg.compute_dtype)


# --------------------------------------------------------------- embedding


def embed_tokens(
    params: SmilesTransformer,
    cfg: TransformerConfig,
    tokens: torch.Tensor,
    injection: Optional[torch.Tensor] = None,
    inject_token: Optional[int] = None,
) -> torch.Tensor:
    """Token embedding with optional per-row soft-token injection over
    every occurrence of `inject_token` (x[hole] = injection[row])."""
    table, norm = params.token_table()
    x = table[tokens]
    if norm is not None:
        x = layer_norm(x, norm.weight, norm.bias)
    if injection is not None:
        holes = (tokens == inject_token)[..., None]
        x = torch.where(holes, injection[:, None, :].to(x.dtype), x)
    return x.to(cfg.compute_dtype)


# ---------------------------------------------------------- full forward


def _qkv(x, blk: Block, cfg: TransformerConfig, cos, sin):
    """LayerNorm, fused qkv projection and rotary over positions [0, T).
    q and k come out contiguous; v is a strided view of the projection."""
    b, t, d = x.shape
    h, dh = cfg.n_head, cfg.head_dim
    y = layer_norm(x, blk.ln_1.weight, blk.ln_1.bias)
    q, k, v = linear(y, blk.attn.c_attn.weight, blk.attn.c_attn.bias).split(d, dim=-1)
    q = apply_rotary(q.view(b, t, h, dh), cos[:t, None, :], sin[:t, None, :])
    k = apply_rotary(k.view(b, t, h, dh), cos[:t, None, :], sin[:t, None, :])
    return q, k, v.view(b, t, h, dh)


def _block_tail(x, attn, blk: Block):
    """Attention output projection and the MLP, each with its residual."""
    x = x + linear(attn, blk.attn.c_proj.weight, blk.attn.c_proj.bias)
    y = layer_norm(x, blk.ln_2.weight, blk.ln_2.bias)
    fc, out = blk.mlpf[0], blk.mlpf[2]
    return x + linear(gelu_tanh(linear(y, fc.weight, fc.bias)), out.weight, out.bias)


def _block_full(x, blk: Block, cfg: TransformerConfig, cos, sin):
    """One block over a full sequence. x: (B, T, D)."""
    b, t, d = x.shape
    q, k, v = _qkv(x, blk, cfg, cos, sin)
    attn = _full_attention(q, k, v, cfg).reshape(b, t, d)
    return _block_tail(x, attn, blk)


def forward_hidden(
    params: SmilesTransformer,
    cfg: TransformerConfig,
    tokens: torch.Tensor,
    injection: Optional[torch.Tensor] = None,
    inject_token: Optional[int] = None,
) -> torch.Tensor:
    """Full forward through all blocks + final LN. tokens: (B, T) -> (B, T, D)."""
    _check_kernel_fields(cfg)
    params = cast_floats(params, cfg.compute_dtype)
    cos, sin = _rotary(cfg, tokens.device)
    x = embed_tokens(params, cfg, tokens, injection, inject_token)
    remat = cfg.remat and torch.is_grad_enabled()
    for blk in params.transformer.h:
        if remat:
            x = checkpoint(_block_full, x, blk, cfg, cos, sin, use_reentrant=False)
        else:
            x = _block_full(x, blk, cfg, cos, sin)
    lnf = params.transformer.ln_f
    return layer_norm(x, lnf.weight, lnf.bias)


def _lm_head(params: SmilesTransformer, cfg: TransformerConfig, hidden: torch.Tensor):
    return linear(hidden, params.lm_head.weight.to(cfg.compute_dtype))


def forward_logits(
    params: SmilesTransformer,
    cfg: TransformerConfig,
    tokens: torch.Tensor,
    injection: Optional[torch.Tensor] = None,
    inject_token: Optional[int] = None,
) -> torch.Tensor:
    """(B, T) -> (B, T, n_tok). With injection this is the reference's
    forward_with_replacement."""
    return _lm_head(params, cfg, forward_hidden(params, cfg, tokens, injection, inject_token))


def stop_token_hidden(hidden: torch.Tensor, tokens: torch.Tensor, stop_token: int) -> torch.Tensor:
    """Hidden state at the first [STOP] position per row (position 0 when a
    row has none, as the JAX one-hot contraction gives)."""
    stop_pos = (tokens == stop_token).int().argmax(dim=1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), stop_pos]


def encode(
    params: SmilesTransformer, cfg: TransformerConfig, tokens: torch.Tensor, stop_token: int
) -> torch.Tensor:
    """(B, T) -> (B, D): hidden state at [STOP]."""
    return stop_token_hidden(forward_hidden(params, cfg, tokens), tokens, stop_token)


def forward_with_stop_emb(
    params: SmilesTransformer,
    cfg: TransformerConfig,
    tokens: torch.Tensor,
    stop_token: int,
    injection: Optional[torch.Tensor] = None,
    inject_token: Optional[int] = None,
):
    """(logits, stop_hidden) in one pass."""
    hidden = forward_hidden(params, cfg, tokens, injection, inject_token)
    return _lm_head(params, cfg, hidden), stop_token_hidden(hidden, tokens, stop_token)


# ----------------------------------------------------------- decode step


@dataclass
class KVCache:
    """(L, 2, B, T, H, Dh) key/value storage; `scale` is the per
    (layer, kv, batch, position, head) dequantization factor when data is
    int8, else None."""

    data: torch.Tensor
    scale: Optional[torch.Tensor] = None


def quantize_kv(x: torch.Tensor):
    """Symmetric per-(..., head) int8 quantization over the head dim.
    x: (..., H, Dh) -> (int8 data, f32 scale (..., H)). torch.round rounds
    half to even, as jnp.round does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def make_empty_cache(
    cfg: TransformerConfig,
    batch: int,
    width: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> KVCache:
    """KV cache sized (L, 2, B, width, H, Dh)."""
    width = width or cfg.n_seq
    shape = (cfg.n_layer, 2, batch, width, cfg.n_head, cfg.head_dim)
    if cfg.kv_quantized:
        return KVCache(
            data=torch.zeros(shape, dtype=torch.int8, device=device),
            scale=torch.zeros(shape[:-1], dtype=cfg.kv_scale_torch_dtype, device=device),
        )
    return KVCache(data=torch.zeros(shape, dtype=dtype or cfg.compute_dtype, device=device))


def _write_kv(cache: KVCache, layer: int, positions, k: torch.Tensor, v: torch.Tensor) -> None:
    """Store k, v (B, [P,] H, Dh) at `positions` (an int or a slice) of one
    layer, quantizing for an int8 cache."""
    if cache.scale is not None:
        for i, x in ((0, k), (1, v)):
            x8, xs = quantize_kv(x)
            cache.data[layer, i, :, positions] = x8
            cache.scale[layer, i, :, positions] = xs.to(cache.scale.dtype)
    else:
        cache.data[layer, 0, :, positions] = k.to(cache.data.dtype)
        cache.data[layer, 1, :, positions] = v.to(cache.data.dtype)


def prefill(
    params: SmilesTransformer,
    cfg: TransformerConfig,
    tokens: torch.Tensor,
    injection: Optional[torch.Tensor] = None,
    inject_token: Optional[int] = None,
    cache: Optional[KVCache] = None,
):
    """Run the full prefix once, filling the KV cache.

    tokens: (B, P). Returns (hidden (B, P, D), cache) where cache holds
    rotated K and V for positions [0, P). Attention here uses the exact
    (unquantized) K and V; decode steps read the stored, possibly int8,
    cache."""
    _check_kernel_fields(cfg)
    b, p = tokens.shape
    params = cast_floats(params, cfg.compute_dtype)
    cos, sin = _rotary(cfg, tokens.device)
    if cache is None:
        cache = make_empty_cache(cfg, b, device=tokens.device)
    x = embed_tokens(params, cfg, tokens, injection, inject_token)
    for layer, blk in enumerate(params.transformer.h):
        q, k, v = _qkv(x, blk, cfg, cos, sin)
        _write_kv(cache, layer, slice(0, p), k, v)
        attn = _full_attention(q, k, v, cfg).reshape(b, p, cfg.n_embd)
        x = _block_tail(x, attn, blk)
    lnf = params.transformer.ln_f
    return layer_norm(x, lnf.weight, lnf.bias), cache


def decode_step(
    params: SmilesTransformer,
    cfg: TransformerConfig,
    token: torch.Tensor,
    pos: int,
    cache: KVCache,
):
    """One autoregressive step: embed `token` (B,), write its K/V at `pos`,
    then attend over [0, pos] (inclusive) against the cache. Returns
    (logits (B, V), cache)."""
    _check_kernel_fields(cfg)
    b = token.shape[0]
    h, dh = cfg.n_head, cfg.head_dim
    params = cast_floats(params, cfg.compute_dtype)
    cos_t, sin_t = _rotary(cfg, token.device)
    cos1, sin1 = cos_t[pos], sin_t[pos]

    table, norm = params.token_table()
    x = table[token]
    if norm is not None:
        x = layer_norm(x, norm.weight, norm.bias)
    x = x.to(cfg.compute_dtype)  # (B, D)

    for layer, blk in enumerate(params.transformer.h):
        y = layer_norm(x, blk.ln_1.weight, blk.ln_1.bias)
        q, k, v = linear(y, blk.attn.c_attn.weight, blk.attn.c_attn.bias).split(cfg.n_embd, dim=-1)
        q = apply_rotary(q.reshape(b, h, dh), cos1, sin1)
        k = apply_rotary(k.reshape(b, h, dh), cos1, sin1)
        v = v.reshape(b, h, dh)
        _write_kv(cache, layer, pos, k, v)
        if cache.scale is not None:
            attn = decode_attention_quant(
                q, cache.data[layer, 0], cache.scale[layer, 0],
                cache.data[layer, 1], cache.scale[layer, 1], pos,
            )
        else:
            attn = decode_attention(q, cache.data[layer, 0], cache.data[layer, 1], pos)
        x = _block_tail(x, attn.reshape(b, cfg.n_embd), blk)
    lnf = params.transformer.ln_f
    x = layer_norm(x, lnf.weight, lnf.bias)
    return linear(x, params.lm_head.weight), cache
