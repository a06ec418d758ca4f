"""COATI with DeepSeek-V2-Lite's block as its SMILES trunk: the plain float32
reference the port's CPU tests hold coati_tpu_torch/models/mla_moe.py to.

The block (arXiv:2405.04434; the published config.json and modeling code of
deepseek-ai/DeepSeek-V2-Lite), per token x of width D, H heads:

    h = x + MLA(RMSNorm(x)),  out = h + FFN(RMSNorm(h)),  RMSNorm eps 1e-6
    MLA: q = W_q x, (H, 192) = [q_nope 128 | q_pe 64]; [c 512 | k_pe 64] =
    W_kva x, c = RMSNorm_kv(c); [k_nope 128 | v 128] = W_kvb c per head;
    q_pe and the one k_pe rotated by YaRN rope (each 64-vector
    de-interleaved, then rotated by halves with cos / sin of
    concat(freqs, freqs)); score = softmax_scale [q_nope | q_pe] .
    [k_nope | k_pe], causal, softmax in float32; out = W_o concat_h(sum p v).
    YaRN: f_extra = theta^(-2i/64), f_inter = f_extra / factor, the ramp
    clamp((i - low) / (high - low), 0, 1) between the floored and ceiled
    correction dims of beta_fast and beta_slow over the original context,
    inv_freq = f_inter ramp + f_extra (1 - ramp); softmax_scale =
    192^-0.5 mscale(factor, mscale_all_dim)^2.
    FFN: layer 0 (and the first n_dense) a SwiGLU down(silu(gate x) * up x)
    of dense_width; the others p = softmax(W_router x) over all n_routed
    experts in float32, the top_k greedy picks (the lower index first among
    equals, no renormalisation, routed scale 1), sum over the picks held
    here of p_e E_e(x) (E_e a SwiGLU of expert_width), plus the shared
    SwiGLU of n_shared * expert_width.

Computed in the full form only, with no kernel, cache or batching.

Departures from the published model, all COATI's: the vocabulary is
COATI's (`mar`, 13,603 tokens) with its [STOP] / [UNK] handling; an
embedding is the final hidden state at the first [STOP] through LayerNorm
(over D) and Linear(D, n_embd_common); an embedding becomes the token that
stands in for [UNK] by SiLU then Linear(n_embd_common, D). The deployment
is one chip's share of the expert layers: only the experts held here add
their part (the others' part is left out, as in the program). Gate and
up weights are stored as one (2W, D) matrix, gate rows first, and the
held experts' stacked, (n_held, 2W, D) and (n_held, D, W).

Weights are a flat dict under the program's parameter names, in PyTorch's
(out, in) layout; the configuration a dict under the published config's
keys (`num_hidden_layers`, `rope_scaling`, ...), with `n_routed_experts` the
experts held here, `first_expert` the first of them and `router_width` the
router's. It imports nothing of the port. The benchmark keeps a copy,
portbench/reference/mla_moe.py, whose functions also take a lower
precision for its control (the `q` arguments, identity here); a test holds
the two to the same logits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class _Exact:
    """float32 throughout: the identity where the benchmark's copy rounds."""

    def w(self, x):
        return x

    act = store = w


EXACT = _Exact()


def matmul(x, w, b, q):
    y = x @ w
    return y if b is None else y + b

LN_EPS = 1e-5


def _mm(x, w, q, b=None):
    """x @ w.T (+ b) of an (out, in) weight, under precision q."""
    return matmul(x, w.t(), b, q)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _mscale(factor, m):
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_range(cfg: dict):
    """(low, high) of the rope ramp."""
    ys = cfg["rope_scaling"]
    dim, base, orig = cfg["qk_rope_head_dim"], cfg["rope_theta"], ys["original_max_position_embeddings"]

    def corr(n_rot):
        return dim * math.log(orig / (n_rot * 2 * math.pi)) / (2 * math.log(base))

    return max(math.floor(corr(ys["beta_fast"])), 0), min(math.ceil(corr(ys["beta_slow"])), dim - 1)


def softmax_scale(cfg: dict) -> float:
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    ys = cfg["rope_scaling"]
    return qk ** -0.5 * _mscale(ys["factor"], ys["mscale_all_dim"]) ** 2


def rope_tables(cfg: dict, n: int, device):
    ys = cfg["rope_scaling"]
    dim, base, factor = cfg["qk_rope_head_dim"], cfg["rope_theta"], ys["factor"]
    f_extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    low, high = yarn_range(cfg)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / max(high - low, 0.001)).clamp(0, 1)
    inv = f_extra / factor * ramp + f_extra * (1 - ramp)
    freqs = torch.outer(torch.arange(n, dtype=torch.float32, device=device), inv)
    emb = torch.cat([freqs, freqs], -1)
    m = _mscale(factor, ys["mscale"]) / _mscale(factor, ys["mscale_all_dim"])
    return emb.cos() * m, emb.sin() * m


def rope(x, cos, sin):
    x = x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin


def _attention(w: dict, p: str, cfg: dict, x, cos, sin, q):
    b, t, _ = x.shape
    h, nope, r = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv = cfg["v_head_dim"]
    lat = cfg["kv_lora_rank"]
    qh = _mm(x, w[p + "self_attn.q_proj.weight"], q).view(b, t, h, nope + r)
    kva = _mm(x, w[p + "self_attn.kv_a_proj_with_mqa.weight"], q)
    c = rms_norm(kva[..., :lat], w[p + "self_attn.kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    k_pe = rope(kva[..., lat:], cos, sin)
    row = q.store(torch.cat([c, k_pe], -1))  # what a decode cache holds of the token
    c, k_pe = row[..., :lat], row[..., lat:]
    kv = _mm(c, w[p + "self_attn.kv_b_proj.weight"], q).view(b, t, h, nope + dv)
    qf = torch.cat([qh[..., :nope], rope(qh[..., nope:], cos[:, None], sin[:, None])], -1)
    kf = torch.cat([kv[..., :nope], k_pe[:, :, None].expand(b, t, h, r)], -1)
    s = torch.einsum("bqhd,bkhd->bhqk", q.act(qf), q.act(kf)) * softmax_scale(cfg)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    probs = s.masked_fill(~causal, float("-inf")).softmax(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", q.act(probs), q.act(kv[..., nope:])).reshape(b, t, h * dv)
    return _mm(o, w[p + "self_attn.o_proj.weight"], q)


def _swiglu(x, gate_up, down, q):
    gate, up = _mm(x, gate_up, q).chunk(2, -1)
    return _mm(F.silu(gate) * up, down, q)


def route(x, w_router, top_k: int, q=EXACT):
    """(weights, experts), each (N, top_k): the router's softmax in float32,
    its top_k largest, the lower index first among equals."""
    p = _mm(x, w_router, q).softmax(-1)
    weights, experts = torch.sort(p, dim=-1, descending=True, stable=True)
    return weights[:, :top_k], experts[:, :top_k]


def moe(w: dict, p: str, cfg: dict, x, q=EXACT):
    """The expert layer on (N, D) tokens: the held picks' p_e E_e(x), expert
    by expert over the tokens that picked it, plus the shared expert."""
    weights, experts = route(x, w[p + "mlp.gate.weight"], cfg["num_experts_per_tok"], q)
    gate_up, down = w[p + "mlp.experts.gate_up"], w[p + "mlp.experts.down"]
    y = torch.zeros_like(x)
    for e in range(gate_up.shape[0]):
        pick = experts == cfg["first_expert"] + e
        rows = pick.any(-1).nonzero()[:, 0]
        if rows.numel():
            pe = (weights * pick)[rows].sum(-1, keepdim=True)
            y[rows] += pe * _swiglu(x[rows], gate_up[e], down[e], q)
    if cfg["n_shared_experts"]:
        y = y + _swiglu(x, w[p + "mlp.shared_experts.gate_up_proj.weight"],
                        w[p + "mlp.shared_experts.down_proj.weight"], q)
    return y


def trunk_hidden(w: dict, cfg: dict, tokens, injection=None, inject_token=None, q=EXACT,
                 inject_at=None):
    """(B, T) tokens -> (B, T, D) final hidden states; where a token equals
    `inject_token` (where `inject_at` does, if given) its embedding is the
    row's `injection` (B, D)."""
    x = q.w(w["xformer.emb.tok_emb.weight"])[tokens]
    if injection is not None:
        where = tokens if inject_at is None else inject_at
        x = torch.where((where == inject_token)[..., None], injection[:, None, :], x)
    x = q.store(x)
    b, t, d = x.shape
    cos, sin = rope_tables(cfg, t, x.device)
    eps = cfg["rms_norm_eps"]
    for i in range(cfg["num_hidden_layers"]):
        p = f"xformer.layers.{i}."
        x = q.store(x + _attention(w, p, cfg, rms_norm(x, w[p + "input_layernorm.weight"], eps),
                                   cos, sin, q))
        y = rms_norm(x, w[p + "post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            f = _swiglu(y, w[p + "mlp.gate_up_proj.weight"], w[p + "mlp.down_proj.weight"], q)
        else:
            f = moe(w, p, cfg, y.reshape(b * t, d), q).view(b, t, d)
        x = q.store(x + f)
    return rms_norm(x, w["xformer.norm.weight"], eps)


def lm_logits(w: dict, hidden, q=EXACT):
    return _mm(hidden, w["xformer.lm_head.weight"], q)


def embed(w: dict, cfg: dict, tokens, stop: int, q=EXACT):
    """(B, T) '[SMILES]...[STOP]' rows -> (B, n_embd_common): the hidden state
    at the first [STOP], LayerNorm over D, Linear."""
    hidden = trunk_hidden(w, cfg, tokens, q=q)
    pos = (tokens == stop).int().argmax(1)
    h = hidden[torch.arange(hidden.shape[0], device=hidden.device), pos]
    h = F.layer_norm(h, (h.shape[-1],), w["smiles_to_clip.0.weight"], w["smiles_to_clip.0.bias"],
                     LN_EPS)
    return _mm(h, w["smiles_to_clip.1.weight"], q, w["smiles_to_clip.1.bias"])


def injected_token(w: dict, h, q=EXACT):
    """An embedding -> the (B, D) token that stands in for [UNK]."""
    return _mm(F.silu(h), w["point_clip_to_special_tokens.1.weight"], q,
               w["point_clip_to_special_tokens.1.bias"])


def decode_logits(w: dict, cfg: dict, h, tokens, unk: int, prefix_len: int, q=EXACT):
    """Teacher-forced logits (B, T, n_tok) behind the embedding h: position
    p gives the distribution of the token at p + 1; the embedding stands in
    for the prompt's [UNK] (the first `prefix_len` tokens)."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    marked = torch.where(pos < prefix_len, tokens, -1)
    hidden = trunk_hidden(w, cfg, tokens, injected_token(w, h, q), unk, q, inject_at=marked)
    return lm_logits(w, hidden, q)
