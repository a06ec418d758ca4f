"""COATI's and COATI2's SMILES trunk and heads, plain.

The trunk is a pre-norm causal transformer with rotary position embedding
(arXiv:2104.09864, cos/sin of concat(freqs, freqs) over the head, applied
to q and k after the head split), tanh-GELU MLPs of 4x width and a final
LayerNorm, all with eps 1e-5. A sequence's embedding is the final hidden
state at its first [STOP]. COATI projects it with LayerNorm then Linear
(`smiles_to_clip`) and turns an embedding into the token it injects over
[UNK] with SiLU then Linear; COATI2 does both with SwiGLU residual stacks
(LayerNorm, Linear to twice the width, silu(second half) * first half,
Linear, plus the input).

Weights are the nested stacked-layer dict of `weights.py`, in (in, out)
layout. Every function takes a precision `q` (lowp.py).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.lowp import EXACT, matmul

LN_EPS = 1e-5


def layer_norm(x, scale, bias):
    return F.layer_norm(x, (x.shape[-1],), scale, bias, LN_EPS)


def rotary_tables(n: int, dh: int, device):
    inv = 1.0 / (10000.0 ** (torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh))
    freqs = torch.outer(torch.arange(n, dtype=torch.float32, device=device), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def trunk_hidden(xf: dict, n_head: int, tokens: torch.Tensor, injection=None, inject_token=None,
                 q=EXACT, inject_at=None) -> torch.Tensor:
    """(B, T) tokens -> (B, T, D) final hidden states; where a token equals
    `inject_token` (where `inject_at` does, if given) its embedding is the
    row's `injection` (B, D)."""
    x = q.w(xf["tok_emb"])[tokens]
    if injection is not None:
        where = tokens if inject_at is None else inject_at
        x = torch.where((where == inject_token)[..., None], injection[:, None, :], x)
    x = q.store(x)
    b, t, d = x.shape
    dh = d // n_head
    cos, sin = rotary_tables(t, dh, x.device)
    cos, sin = cos[:, None, :], sin[:, None, :]
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    blk = xf["blocks"]
    for i in range(blk["w_attn"].shape[0]):
        y = layer_norm(x, blk["ln1_scale"][i], blk["ln1_bias"][i])
        qkv = matmul(y, blk["w_attn"][i], blk["b_attn"][i], q)
        qh, kh, vh = (z.reshape(b, t, n_head, dh) for z in qkv.split(d, dim=-1))
        qh, kh = _rotate(qh, cos, sin), _rotate(kh, cos, sin)
        kh, vh = q.kv(kh), q.kv(vh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.act(qh), q.act(kh)) / math.sqrt(dh)
        probs = scores.masked_fill(~causal, float("-inf")).softmax(dim=-1)
        att = torch.einsum("bhqk,bkhd->bqhd", q.act(probs), q.act(vh)).reshape(b, t, d)
        x = q.store(x + matmul(att, blk["w_proj"][i], blk["b_proj"][i], q))
        y = layer_norm(x, blk["ln2_scale"][i], blk["ln2_bias"][i])
        hid = F.gelu(matmul(y, blk["w_fc"][i], blk["b_fc"][i], q), approximate="tanh")
        x = q.store(x + matmul(hid, blk["w_out"][i], blk["b_out"][i], q))
    return layer_norm(x, xf["lnf_scale"], xf["lnf_bias"])


def lm_logits(xf: dict, hidden: torch.Tensor, q=EXACT) -> torch.Tensor:
    return matmul(hidden, xf["lm_head"], None, q)


def stop_hidden(hidden: torch.Tensor, tokens: torch.Tensor, stop: int) -> torch.Tensor:
    """The hidden state at each row's first [STOP] (position 0 without one)."""
    pos = (tokens == stop).int().argmax(dim=1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), pos]


def _swiglu_resnet(p: dict, x, q):
    y = matmul(layer_norm(x, p["ln_scale"], p["ln_bias"]), p["w1"], p["b1"], q)
    value, gate = y.chunk(2, dim=-1)
    return matmul(F.silu(gate) * value, p["w2"], p["b2"], q) + x


def embed(w: dict, cfg: dict, tokens: torch.Tensor, stop: int, q=EXACT) -> torch.Tensor:
    """(B, T) '[SMILES]...[STOP]' rows -> (B, embed_dim) embeddings."""
    h = stop_hidden(trunk_hidden(w["xformer"], cfg["n_head"], tokens, q=q), tokens, stop)
    if cfg["family"] == "coati2":
        return _swiglu_resnet(w["smiles_to_coati"], h, q)
    return clip_projection(w["smiles_to_clip"], h, q)


def clip_projection(p: dict, h, q=EXACT):
    """COATI's projection heads: LayerNorm, then Linear."""
    return matmul(layer_norm(h, p["ln_scale"], p["ln_bias"]), p["w"], p["b"], q)


def injected_token(w: dict, cfg: dict, h: torch.Tensor, q=EXACT) -> torch.Tensor:
    """An embedding -> the token that stands in for [UNK] when decoding."""
    if cfg["family"] == "coati2":
        return _swiglu_resnet(w["coati_to_token"], h, q)
    return matmul(F.silu(h), w["token_w"], w["token_b"], q)


def decode_logits(w: dict, cfg: dict, h: torch.Tensor, tokens: torch.Tensor, unk: int,
                  prefix_len: int, q=EXACT) -> torch.Tensor:
    """Teacher-forced logits (B, T, n_tok) of a decode behind the embedding
    h: position p gives the distribution of the token at p + 1. The
    embedding stands in for the prompt's [UNK] (the first `prefix_len`
    tokens); a generated [UNK] is an ordinary token, as in a decoder that
    injects into its prompt once and then steps through a cache."""
    xf = w["xformer"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    marked = torch.where(pos < prefix_len, tokens, -1)
    hidden = trunk_hidden(xf, cfg["n_head"], tokens, injected_token(w, cfg, h, q), unk, q,
                          inject_at=marked)
    return lm_logits(xf, hidden, q)
