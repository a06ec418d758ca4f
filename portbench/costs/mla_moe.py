"""Costs of COATI with DeepSeek-V2-Lite's block as its trunk
(configs/coati_dsv2lite.json): model FLOPs of a round trip and the least
time of K6 and of the grouped expert products. Operations are 2 a
multiply-add; every count is of live work (costs/__init__.py).

Per token and layer of width D with H heads (nope 128, rope 64, v 128,
latent 512), the full form (encode, prefill) at position t takes the
projections q 2 D H (nope + rope), kv_a 2 D (latent + rope), kv_b
2 latent H (nope + v), o 2 H v D, and causal attention over t + 1 keys,
2 (t + 1) H (nope + rope + v). A decode step at position p takes the
absorbed form: q, kv_a and o as above, q_lat 2 H nope latent, attention
2 (p + 1) H (2 latent + rope) and W_UV 2 H latent v. The FFN is the dense
SwiGLU, 6 D W_dense, on the first layers, then the router 2 D n_routed,
the shared SwiGLU 6 D W_shared and the held experts' SwiGLU 6 D W_expert
for each (token, held expert) pair: top_k n_held / n_routed of them a
token on average, as even routing gives. Each position whose logits are
used adds 2 D n_tok; a row adds the clip projection 2 D E and the
injected token's 2 E D.

K6 (ops/kernels/mla_decode.py) at position pos over `live` rows reads the
latent rows [0, pos] (latent + rope values each) and q (H rows of latent +
rope), and writes o_lat (H x latent), all bf16; it takes 2 (pos + 1) H
(2 latent + rope) operations a row on the tensor cores. The grouped expert
products over a set of passes read each active held expert's weights once
a pass (3 D W_expert bf16 values) and, for each pair, its input row (D),
the gate/up output and its SwiGLU (3 W) and the down output (D), bf16, and
take 6 D W_expert operations a pair.
"""

from __future__ import annotations

import numpy as np

from portbench.costs import kernels

BF16 = 2


def _widths(cfg: dict):
    return (cfg["hidden_size"], cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
            cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"])


def _ffn_per_token(cfg: dict) -> float:
    """FFN operations a token, summed over the layers."""
    d, n = cfg["hidden_size"], cfg["num_hidden_layers"]
    dense = cfg["first_k_dense_replace"]
    we = cfg["moe_intermediate_size"]
    pairs = cfg["num_experts_per_tok"] * cfg["n_routed_experts"] / cfg["router_width"]
    moe = 2.0 * d * cfg["router_width"] + 6.0 * d * cfg["n_shared_experts"] * we \
        + pairs * 6.0 * d * we
    return dense * 6.0 * d * cfg["intermediate_size"] + (n - dense) * moe


def full_flops(lengths, cfg: dict) -> float:
    """A full-sequence pass over rows of the given live lengths."""
    d, h, nope, rope, dv, lat = _widths(cfg)
    lengths = np.asarray(lengths, np.float64)
    proj = 2.0 * d * h * (nope + rope) + 2.0 * d * (lat + rope) + 2.0 * lat * h * (nope + dv) \
        + 2.0 * h * dv * d
    attn = 2.0 * h * (nope + rope + dv) * (lengths * (lengths + 1) / 2).sum()
    per_token = cfg["num_hidden_layers"] * proj + _ffn_per_token(cfg)
    return float(per_token * lengths.sum() + cfg["num_hidden_layers"] * attn)


def decode_flops(positions, cfg: dict) -> float:
    """One absorbed decode step per entry of `positions` (the position each
    live row's step reads up to), each with its vocabulary head."""
    d, h, nope, rope, dv, lat = _widths(cfg)
    p = np.asarray(positions, np.float64)
    proj = 2.0 * d * h * (nope + rope) + 2.0 * d * (lat + rope) + 2.0 * h * nope * lat \
        + 2.0 * h * lat * dv + 2.0 * h * dv * d
    attn = 2.0 * h * (2 * lat + rope) * (p + 1).sum()
    per_step = cfg["num_hidden_layers"] * proj + _ffn_per_token(cfg) + 2.0 * d * cfg["vocab_size"]
    return float(per_step * p.size + cfg["num_hidden_layers"] * attn)


def head_flops(cfg: dict) -> float:
    d, e = cfg["hidden_size"], cfg["n_embd_common"]
    return 2.0 * d * e + 2.0 * e * d


def k6_bytes(live: float, pos: int, heads: int, latent: int, rope: int) -> float:
    return live * BF16 * ((pos + 1) * (latent + rope) + heads * (latent + rope) + heads * latent)


def k6_ops(live: float, pos: int, heads: int, latent: int, rope: int) -> float:
    return 2.0 * live * heads * (pos + 1) * (2 * latent + rope)


def k6_s(live: float, pos: int, heads: int, latent: int, rope: int) -> float:
    """The least time of one launch at `pos` over `live` rows."""
    return kernels.bound_s(k6_bytes(live, pos, heads, latent, rope),
                           k6_ops(live, pos, heads, latent, rope), "bfloat16")


def expert_bytes(pairs: float, active: float, d: int, w: int) -> float:
    return BF16 * (active * 3.0 * d * w + pairs * (2.0 * d + 3.0 * w))


def expert_ops(pairs: float, d: int, w: int) -> float:
    return 6.0 * pairs * d * w


def experts_s(pairs: float, active: float, d: int, w: int) -> float:
    """The least time of the grouped expert products of a set of passes
    together: `pairs` (token, held expert) pairs, `active` the held experts
    with a token summed over the passes."""
    return kernels.bound_s(expert_bytes(pairs, active, d, w), expert_ops(pairs, d, w), "bfloat16")
