"""DeepSeek-V2's block as a COATI trunk: multi-head latent attention (MLA)
and a mixture of experts, with a latent decode cache.

The equations of DeepSeek-V2-Lite (arXiv:2405.04434; its published
config.json and modeling code), per token x of width D with H heads:

    h   = x + MLA(RMSNorm(x)),  out = h + FFN(RMSNorm(h))   (RMSNorm eps 1e-6)
    q   = W_q x                 (H, nope + rope)  -> [q_nope | q_pe]
    [c | k_pe] = W_kva x;  c = RMSNorm_kv(c)      (latent 512, one k_pe of 64)
    [k_nope | v] = W_kvb c      per head (nope, v)
    q_pe, k_pe rotated by YaRN rope at the token's position (ops/rotary.py)
    score = softmax_scale [q_nope | q_pe] . [k_nope | k_pe], causal, float32
    out = W_o concat_h(sum_t p v)

The first `n_dense` layers' FFN is a SwiGLU of `dense_width`; the others
are expert layers (ops/moe.py): the router over all `n_routed` experts,
the top_k greedy picks, p_e E_e(x) over the picks among the experts held
here ([first_expert, first_expert + n_held)), plus the shared SwiGLU of
`n_shared * expert_width`. A final RMSNorm comes before the LM head and
before the hidden state an encoder takes.

Encode and prefill compute the full form, attention through
`scaled_dot_product_attention` with v zero-padded to the qk width. Decode
computes the absorbed form over a latent cache (`LatentCache`, (L, B, T,
latent + rope) in the compute dtype: RMSNorm_kv(c) and the rotated k_pe,
one row a token and layer, shared by every head): q_lat = W_UK^T q_nope,
o_lat = K6(q_lat | q_pe, cache) (ops/kernels/mla_decode.py), o = W_UV o_lat,
W_UK and W_UV the per-head halves of W_kvb. It equals the full form in
exact arithmetic.

The parameters live in `MlaMoeTransformer`. `forward_hidden`, `prefill`,
`decode_step`, `decode_step_at`, `make_empty_cache` and `decode_tables`
take the arguments of models/transformer.py's, and models/trunks.py sends
an `MlaMoeConfig` here, so the COATI API, the sampler and the decode graph
serve this trunk unchanged.
The layout departs from the published checkpoint's in two ways, neither
in the mathematics: gate and up projections are one (2W, D) weight, gate
rows first, and the held experts' weights are stacked, (n_held, 2W, D)
and (n_held, D, W).

Spans: `mla.attend` (the attention of a full-sequence pass), `moe.route`
and `moe.experts` (an expert layer's routing and its products). Counters
(read by `publish_counters` once a call): `moe.pairs_here`,
`moe.expert_tokens.<layer>.<expert>`, `moe.passes`, `moe.experts_active`,
`moe.peak_over_mean_ppm` (see ops/moe.MoeCounters).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from coati_tpu_torch.common import tracing
from coati_tpu_torch.ops import moe
from coati_tpu_torch.ops.kernels.mla_decode import mla_decode
from coati_tpu_torch.ops.layers import cast_floats, linear, rms_norm
from coati_tpu_torch.ops.rotary import apply_rotary_interleaved, yarn_mscale, yarn_tables

MOE_CHUNK = 16384  # tokens an expert layer takes at once in a full-sequence pass


@dataclass(frozen=True)
class MlaMoeConfig:
    """DeepSeek-V2-Lite's block (published widths as defaults); n_layer,
    n_embd, n_head, n_seq, n_tok and dtype come from the model's config
    (`CoatiConfig.xformer_config`)."""

    n_layer: int = 27
    n_embd: int = 2048
    n_head: int = 16
    n_seq: int = 250
    n_tok: int = 102400
    dtype: str = "float32"
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_dense: int = 1  # first_k_dense_replace
    dense_width: int = 10944  # intermediate_size
    expert_width: int = 1408  # moe_intermediate_size
    n_routed: int = 64  # the router's width
    top_k: int = 6
    n_shared: int = 2
    first_expert: int = 0  # the experts held here: [first_expert, first_expert + n_held)
    n_held: int = 64
    rms_eps: float = 1e-6
    rope_theta: float = 10000.0
    yarn_factor: float = 40.0
    yarn_original: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 0.707
    yarn_mscale_all_dim: float = 0.707

    def replace(self, **changes) -> "MlaMoeConfig":
        return dataclasses.replace(self, **changes)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def cache_width(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        m = yarn_mscale(self.yarn_factor, self.yarn_mscale_all_dim)
        return self.qk_dim ** -0.5 * m * m

    @property
    def n_moe(self) -> int:
        return self.n_layer - self.n_dense


# ------------------------------------------------------------ parameters


class _RMSNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))


class _Attention(nn.Module):
    def __init__(self, cfg: MlaMoeConfig):
        super().__init__()
        d, h = cfg.n_embd, cfg.n_head
        self.q_proj = nn.Linear(d, h * cfg.qk_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, cfg.cache_width, bias=False)
        self.kv_a_layernorm = _RMSNorm(cfg.kv_lora_rank)
        self.kv_b_proj = nn.Linear(cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                                   bias=False)
        self.o_proj = nn.Linear(h * cfg.v_head_dim, d, bias=False)


class _SwiGLU(nn.Module):
    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_up_proj = nn.Linear(d, 2 * width, bias=False)
        self.down_proj = nn.Linear(width, d, bias=False)


class _Experts(nn.Module):
    """The held experts' weights, stacked (PyTorch's default Linear
    initialisation per expert)."""

    def __init__(self, d: int, width: int, n: int):
        super().__init__()
        self.gate_up = nn.Parameter(torch.empty(n, 2 * width, d).uniform_(-d ** -0.5, d ** -0.5))
        self.down = nn.Parameter(torch.empty(n, d, width).uniform_(-width ** -0.5, width ** -0.5))


class _MoE(nn.Module):
    def __init__(self, cfg: MlaMoeConfig):
        super().__init__()
        d = cfg.n_embd
        self.gate = nn.Linear(d, cfg.n_routed, bias=False)  # the router
        self.experts = _Experts(d, cfg.expert_width, cfg.n_held)
        self.shared_experts = _SwiGLU(d, cfg.n_shared * cfg.expert_width) if cfg.n_shared else None


class MlaMoeBlock(nn.Module):
    def __init__(self, cfg: MlaMoeConfig, dense: bool):
        super().__init__()
        self.input_layernorm = _RMSNorm(cfg.n_embd)
        self.self_attn = _Attention(cfg)
        self.post_attention_layernorm = _RMSNorm(cfg.n_embd)
        self.mlp = _SwiGLU(cfg.n_embd, cfg.dense_width) if dense else _MoE(cfg)


class _Embedding(nn.Module):
    def __init__(self, n_tok: int, d: int):
        super().__init__()
        self.tok_emb = nn.Embedding(n_tok, d)


class MlaMoeTransformer(nn.Module):
    """Parameters of the trunk; `moe_tokens` (n_moe, n_held) and `moe_stats`
    (n_moe, 3) are the expert layers' counters on the card (buffers, not
    saved)."""

    def __init__(self, cfg: MlaMoeConfig):
        super().__init__()
        self.emb = _Embedding(cfg.n_tok, cfg.n_embd)
        self.layers = nn.ModuleList(MlaMoeBlock(cfg, i < cfg.n_dense) for i in range(cfg.n_layer))
        self.norm = _RMSNorm(cfg.n_embd)
        self.lm_head = nn.Linear(cfg.n_embd, cfg.n_tok, bias=False)
        self.register_buffer("moe_tokens", torch.zeros(cfg.n_moe, cfg.n_held, dtype=torch.long),
                             persistent=False)
        self.register_buffer("moe_stats", torch.zeros(cfg.n_moe, 3, dtype=torch.float64),
                             persistent=False)

    def token_table(self):
        return self.emb.tok_emb.weight, None


def _counters(params: MlaMoeTransformer, layer: int, cfg: MlaMoeConfig) -> moe.MoeCounters:
    i = layer - cfg.n_dense
    return moe.MoeCounters(params.moe_tokens[i], params.moe_stats[i])


def publish_counters(params: MlaMoeTransformer) -> None:
    """Read the expert layers' counters from the card (one small copy),
    add them to the tracer's counters and zero them."""
    tokens = params.moe_tokens
    counts, stats = tokens.tolist(), params.moe_stats.sum(0).tolist()
    tokens.zero_()
    params.moe_stats.zero_()
    tracing.count("moe.pairs_here", sum(map(sum, counts)))
    for layer, row in enumerate(counts):
        for e, n in enumerate(row):
            tracing.count(f"moe.expert_tokens.{layer}.{e}", n)
    passes, active, peak = stats
    tracing.count("moe.passes", round(passes))
    tracing.count("moe.experts_active", round(active))
    tracing.count("moe.peak_over_mean_ppm", round(peak * 1e6))


# -------------------------------------------------------------- pieces


def decode_tables(cfg: MlaMoeConfig, device) -> tuple:
    """The YaRN (cos, sin) tables (n_seq, rope), float32."""
    return yarn_tables(cfg.n_seq, cfg.qk_rope_head_dim, cfg.rope_theta, cfg.yarn_factor,
                       cfg.yarn_original, cfg.yarn_beta_fast, cfg.yarn_beta_slow,
                       cfg.yarn_mscale, cfg.yarn_mscale_all_dim, device=device)


def _ffn(x: torch.Tensor, blk: MlaMoeBlock, params, layer: int, cfg: MlaMoeConfig):
    """The block's FFN on (N, D) tokens, in chunks of MOE_CHUNK."""
    mlp = blk.mlp
    if isinstance(mlp, _SwiGLU):
        return moe.swiglu_mlp(x, mlp.gate_up_proj.weight, mlp.down_proj.weight)
    shared = mlp.shared_experts
    counters = _counters(params, layer, cfg)
    out = []
    for s in range(0, x.shape[0], MOE_CHUNK):
        out.append(moe.expert_layer(
            x[s: s + MOE_CHUNK], mlp.gate.weight, mlp.experts.gate_up, mlp.experts.down,
            None if shared is None else shared.gate_up_proj.weight,
            None if shared is None else shared.down_proj.weight,
            cfg.top_k, cfg.first_expert, counters))
    return out[0] if len(out) == 1 else torch.cat(out)


def _ffn_residual(x: torch.Tensor, blk: MlaMoeBlock, params, layer: int, cfg: MlaMoeConfig):
    y = rms_norm(x, blk.post_attention_layernorm.weight, cfg.rms_eps)
    shape = y.shape
    return x + _ffn(y.reshape(-1, shape[-1]), blk, params, layer, cfg).view(shape)


def _latent(y: torch.Tensor, attn: _Attention, cfg: MlaMoeConfig, cos, sin) -> torch.Tensor:
    """[RMSNorm_kv(c) | rope(k_pe)] (..., latent + rope): the cache row."""
    kva = linear(y, attn.kv_a_proj_with_mqa.weight)
    c, k_pe = kva.split([cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    c = rms_norm(c, attn.kv_a_layernorm.weight, cfg.rms_eps)
    return torch.cat([c, apply_rotary_interleaved(k_pe, cos, sin)], dim=-1)


def _attend_full(x: torch.Tensor, attn: _Attention, cfg: MlaMoeConfig, cos, sin):
    """The full form over (B, T, D): (attention output (B, T, D), cache rows
    (B, T, latent + rope))."""
    b, t, _ = x.shape
    h, nope, rope, dv = cfg.n_head, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = linear(x, attn.q_proj.weight).view(b, t, h, nope + rope)
    q_pe = apply_rotary_interleaved(q[..., nope:], cos[:t, None], sin[:t, None])
    rows = _latent(x, attn, cfg, cos[:t], sin[:t])
    kv = linear(rows[..., : cfg.kv_lora_rank], attn.kv_b_proj.weight).view(b, t, h, nope + dv)
    k = torch.cat([kv[..., :nope], rows[:, :, None, cfg.kv_lora_rank:].expand(b, t, h, rope)], -1)
    q = torch.cat([q[..., :nope], q_pe], dim=-1)
    v = F.pad(kv[..., nope:], (0, nope + rope - dv))  # to the qk width
    with tracing.span("mla.attend"):
        o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                           is_causal=True, scale=cfg.softmax_scale)
    o = o[..., :dv].transpose(1, 2).reshape(b, t, h * dv)
    return linear(o, attn.o_proj.weight), rows


def _blocks_full(params: MlaMoeTransformer, cfg: MlaMoeConfig, x: torch.Tensor, cache=None):
    cos, sin = decode_tables(cfg, x.device)
    for layer, blk in enumerate(params.layers):
        y = rms_norm(x, blk.input_layernorm.weight, cfg.rms_eps)
        o, rows = _attend_full(y, blk.self_attn, cfg, cos, sin)
        if cache is not None:
            cache.data[layer, :, : x.shape[1]] = rows.to(cache.data.dtype)
        x = _ffn_residual(x + o, blk, params, layer, cfg)
    return rms_norm(x, params.norm.weight, cfg.rms_eps)


def _embed(params, cfg, tokens, injection, inject_token):
    x = params.emb.tok_emb.weight[tokens]
    if injection is not None:
        x = torch.where((tokens == inject_token)[..., None], injection[:, None, :].to(x.dtype), x)
    return x.to(cfg.compute_dtype)


def forward_hidden(params: MlaMoeTransformer, cfg: MlaMoeConfig, tokens: torch.Tensor,
                   injection: Optional[torch.Tensor] = None,
                   inject_token: Optional[int] = None) -> torch.Tensor:
    """(B, T) -> (B, T, D) final hidden states, the full form."""
    params = cast_floats(params, cfg.compute_dtype)
    return _blocks_full(params, cfg, _embed(params, cfg, tokens, injection, inject_token))


# ---------------------------------------------------------------- decode


@dataclass
class LatentCache:
    """(L, B, T, latent + rope) rows of RMSNorm_kv(c) and the rotated k_pe;
    `scale` is always None (no quantized form)."""

    data: torch.Tensor
    scale: Optional[torch.Tensor] = None


def make_empty_cache(cfg: MlaMoeConfig, batch: int, width: Optional[int] = None,
                     dtype: Optional[torch.dtype] = None, device=None) -> LatentCache:
    width = width or cfg.n_seq
    return LatentCache(torch.zeros((cfg.n_layer, batch, width, cfg.cache_width),
                                   dtype=dtype or cfg.compute_dtype, device=device))


def prefill(params: MlaMoeTransformer, cfg: MlaMoeConfig, tokens: torch.Tensor,
            injection: Optional[torch.Tensor] = None, inject_token: Optional[int] = None,
            cache: Optional[LatentCache] = None):
    """The prefix (B, P) once through the full form, its cache rows written
    at [0, P). Returns (hidden (B, P, D), cache)."""
    params = cast_floats(params, cfg.compute_dtype)
    if cache is None:
        cache = make_empty_cache(cfg, tokens.shape[0], device=tokens.device)
    x = _embed(params, cfg, tokens, injection, inject_token)
    return _blocks_full(params, cfg, x, cache), cache


def _decode_one(params, cfg: MlaMoeConfig, token, cos1, sin1, cache: LatentCache, at, pos):
    """Logits (B, V) of one absorbed decode step: each layer's cache row
    (B, latent + rope) is stored at `at` (a host int, or a one-element
    int64 index on the card), then K6 reads the cache up to `pos`."""
    params = cast_floats(params, cfg.compute_dtype)
    b = token.shape[0]
    h, nope, dv, lat = cfg.n_head, cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    x = params.emb.tok_emb.weight[token].to(cfg.compute_dtype)
    for layer, blk in enumerate(params.layers):
        attn = blk.self_attn
        y = rms_norm(x, blk.input_layernorm.weight, cfg.rms_eps)
        q = linear(y, attn.q_proj.weight).view(b, h, cfg.qk_dim)
        rows = _latent(y, attn, cfg, cos1, sin1).to(cache.data.dtype)
        if isinstance(at, int):
            cache.data[layer, :, at] = rows
        else:
            cache.data[layer].index_copy_(1, at, rows[:, None])
        w_kvb = attn.kv_b_proj.weight.view(h, nope + dv, lat)
        q_lat = torch.bmm(q[..., :nope].transpose(0, 1), w_kvb[:, :nope])  # (H, B, latent)
        q_abs = torch.cat([q_lat.transpose(0, 1), apply_rotary_interleaved(q[..., nope:], cos1, sin1)],
                          dim=-1)
        o_lat = mla_decode(q_abs, cache.data[layer], pos, cfg.softmax_scale, lat)
        o = torch.bmm(o_lat.transpose(0, 1), w_kvb[:, nope:].transpose(1, 2))  # (H, B, v)
        x = x + linear(o.transpose(0, 1).reshape(b, h * dv), attn.o_proj.weight)
        x = _ffn_residual(x, blk, params, layer, cfg)
    x = rms_norm(x, params.norm.weight, cfg.rms_eps)
    return linear(x, params.lm_head.weight)


def decode_step(params, cfg: MlaMoeConfig, token: torch.Tensor, pos: int, cache: LatentCache):
    """One step at host position `pos`: (logits (B, V), cache)."""
    cos, sin = decode_tables(cfg, token.device)
    return _decode_one(params, cfg, token, cos[pos], sin[pos], cache, pos, pos), cache


def decode_step_at(params, cfg: MlaMoeConfig, token: torch.Tensor, pos: torch.Tensor,
                   cache: LatentCache, tables: tuple):
    """decode_step at the position held in `pos` (one int32 on the card,
    which no host code reads): the cache row is written by index_copy_, the
    rope row gathered from `tables` (decode_tables, built once by the
    caller), and K6 reads pos on the card. Returns (logits (B, V), cache)."""
    index = pos.long()
    cos1, sin1 = (t.index_select(0, index)[0] for t in tables)
    return _decode_one(params, cfg, token, cos1, sin1, cache, index, pos), cache

