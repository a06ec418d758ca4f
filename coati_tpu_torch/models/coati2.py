"""COATI2: the SMILES-transformer-only model with SwiGLU projection heads.

PyTorch counterpart of coati_tpu/models/coati2.py (itself the reference's
coati/models/simple_coati2/transformer_only.py: COATI_Smiles_Inference :43,
SwiGLU :37, SwiGLUResNet :19). The trunk is COATI's rotary transformer
(models/transformer.py, with its kernels: K2 or K5f for full sequences, K1
for decode steps); COATI2 adds wider embeddings, SwiGLU heads and the
property-conditioning vocabulary (coati2_12_12: [PROPS]...[ENDPROPS],
[IntMolLogP], [PercentQED], [TPSA], [CHIRAL]/[RACEMIC], ...).

The parameters live in `Coati2Model`, an nn.Module under the reference's
state-dict keys ('xformer.*', 'smiles_to_coati.*', 'coati_to_token.*'), so
a reference document loads with load_state_dict(strict=True). A fresh
`Coati2Model(cfg)` takes PyTorch's default initialisation, which coati_tpu's
init_coati2 imitates.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from coati_tpu_torch.models.api import InjectedDecoder
from coati_tpu_torch.models.coati import clip_loss
from coati_tpu_torch.models.transformer import (
    SmilesTransformer,
    TransformerConfig,
    forward_hidden,
    forward_logits,
    stop_token_hidden,
)
from coati_tpu_torch.ops.layers import cast_floats, layer_norm, linear, swiglu
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer


@dataclass(frozen=True)
class Coati2Config:
    """Field names of coati_tpu's Coati2Config (and of the reference
    constructor, transformer_only.py:49-62), so stored model_kwargs map 1:1.
    The decode cache is TransformerConfig's default: int8 under bfloat16,
    else the compute dtype."""

    n_layer_xformer: int = 16
    n_hidden_xformer: int = 256
    embed_dim: int = 256
    n_head: int = 16
    n_seq: int = 80
    mlp_dropout: float = 0.0
    enc_to_coati: str = "linear"
    n_direct_clr: int = 64
    n_tok: int = 4
    biases: bool = True
    dtype: str = "float32"
    precision: str = "default"
    remat: bool = False
    softmax_dtype: str = "float32"
    prefill_kernel: str = "auto"
    topk_recall: float = 0.8

    def replace(self, **changes) -> "Coati2Config":
        return dataclasses.replace(self, **changes)

    @property
    def xformer_config(self) -> TransformerConfig:
        return TransformerConfig(
            n_layer=self.n_layer_xformer,
            n_embd=self.n_hidden_xformer,
            n_head=self.n_head,
            n_seq=self.n_seq,
            n_tok=self.n_tok,
            biases=self.biases,
            norm_embed=False,
            dtype=self.dtype,
            precision=self.precision,
            remat=self.remat,
            softmax_dtype=self.softmax_dtype,
            prefill_kernel=self.prefill_kernel,
            topk_recall=self.topk_recall,
        )


# ------------------------------------------------------------ parameters


class SwiGLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x)


class SwiGLUResNet(nn.Module):
    """net = Sequential(LayerNorm, Dropout, Linear(d_in, 2 d_out), SwiGLU,
    Linear(d_out, d_out)), applied with a residual: keys net.0, net.2,
    net.4 (transformer_only.py:19-34)."""

    def __init__(self, d_in: int, d_out: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(
            nn.LayerNorm(d_in), nn.Dropout(dropout), nn.Linear(d_in, 2 * d_out), SwiGLU(),
            nn.Linear(d_out, d_out),
        )


def _smiles_to_coati(cfg: Coati2Config) -> nn.Module:
    d, e = cfg.n_hidden_xformer, cfg.embed_dim
    if cfg.enc_to_coati == "linear":
        # REFERENCE QUIRK: the LayerNorm is over embed_dim (transformer_only.py:86-89)
        return nn.Sequential(nn.LayerNorm(e), nn.Linear(d, e))
    if cfg.enc_to_coati == "swiglu_mlp":
        return nn.Sequential(nn.LayerNorm(d), nn.Linear(d, 2 * e), SwiGLU(), nn.Linear(e, e))
    if cfg.enc_to_coati == "swiglu_resnet":
        return SwiGLUResNet(d, e, cfg.mlp_dropout)
    raise ValueError(f"unknown enc_to_coati {cfg.enc_to_coati!r}")


class Coati2Model(nn.Module):
    """Parameters of COATI2, under the reference's keys."""

    def __init__(self, cfg: Coati2Config):
        super().__init__()
        self.xformer = SmilesTransformer(cfg.xformer_config)
        self.smiles_to_coati = _smiles_to_coati(cfg)
        self.coati_to_token = SwiGLUResNet(cfg.embed_dim, cfg.embed_dim, cfg.mlp_dropout)


# ------------------------------------------------------------- functions


def _swiglu_stack(ln: nn.LayerNorm, fc: nn.Linear, out: nn.Linear, x: torch.Tensor):
    y = layer_norm(x, ln.weight, ln.bias)
    y = swiglu(linear(y, fc.weight, fc.bias))
    return linear(y, out.weight, out.bias)


def apply_swiglu_resnet(p: SwiGLUResNet, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm -> Linear -> SwiGLU -> Linear, plus the input."""
    return _swiglu_stack(p.net[0], p.net[2], p.net[4], x) + x


def smiles_to_coati(params: Coati2Model, cfg: Coati2Config, h: torch.Tensor) -> torch.Tensor:
    """The [STOP] hidden state (B, n_hidden_xformer) -> (B, embed_dim)."""
    p = params.smiles_to_coati
    if cfg.enc_to_coati == "linear":
        return linear(layer_norm(h, p[0].weight, p[0].bias), p[1].weight, p[1].bias)
    if cfg.enc_to_coati == "swiglu_mlp":
        return _swiglu_stack(p[0], p[1], p[3], h)
    return apply_swiglu_resnet(p, h)


def encode_tokens(
    params: Coati2Model, cfg: Coati2Config, tokens: torch.Tensor, stop_token: int
) -> torch.Tensor:
    """(B, T) -> (B, embed_dim): the COATI2 embedding of the [STOP] hidden
    state, in the compute dtype."""
    params = cast_floats(params, cfg.xformer_config.compute_dtype)
    hidden = forward_hidden(params.xformer, cfg.xformer_config, tokens)
    return smiles_to_coati(params, cfg, stop_token_hidden(hidden, tokens, stop_token))


def coati_to_token(params: Coati2Model, h: torch.Tensor) -> torch.Tensor:
    """The embedding -> the token injected over [UNK], in h's dtype."""
    return apply_swiglu_resnet(cast_floats(params.coati_to_token, h.dtype), h)


# ------------------------------------------------------ training objective


def direct_clr_loss(
    h1: torch.Tensor,
    h2: torch.Tensor,
    bad_rows: torch.Tensor,
    n_direct_clr: int,
    inv_temp: float = 10.0,
) -> torch.Tensor:
    """directCLR (Jing et al. 2021, arXiv:2110.09348): symmetric InfoNCE on
    the leading `n_direct_clr` dims of the embedding, L2-normalized, with
    the logits scaled by inv_temp; no projection head."""
    z1 = h1[:, :n_direct_clr].float()
    z2 = h2[:, :n_direct_clr].float()
    z1 = z1 / z1.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    z2 = z2 / z2.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    return clip_loss(z1 * inv_temp, z2, bad_rows)


def training_forward(
    params: Coati2Model,
    cfg: Coati2Config,
    tokens: torch.Tensor,
    raw_tokens: torch.Tensor,
    rand_tokens: torch.Tensor,
    stop_token: int,
    unk_token: int,
    pad_token: int = 0,
):
    """The COATI2 recipe's training forward: both SMILES views of each
    molecule (canonical `raw_tokens`, permuted `rand_tokens`, one width)
    encoded as one doubled batch; the canonical embedding mapped through
    coati_to_token and injected over [UNK] in the property-conditioned AR
    target `tokens`. Rows the transform failed arrive all [PAD] (31 in
    coati2_12_12) and are flagged bad.

    Returns (h_canonical, h_permuted, logits, bad_rows)."""
    xcfg = cfg.xformer_config
    params = cast_floats(params, xcfg.compute_dtype)  # once: the trunk runs twice
    views = torch.cat([raw_tokens, rand_tokens], dim=0)
    hidden = forward_hidden(params.xformer, xcfg, views)
    h1, h2 = smiles_to_coati(params, cfg, stop_token_hidden(hidden, views, stop_token)).chunk(2)
    h_token = apply_swiglu_resnet(params.coati_to_token, h1)
    logits = forward_logits(params.xformer, xcfg, tokens, h_token, unk_token)
    bad_rows = (tokens == pad_token).all(dim=-1)
    return h1, h2, logits, bad_rows


# ------------------------------------------------------------------- API


class COATI2(InjectedDecoder):
    """COATI_Smiles_Inference's surface: an invertible 2D-only embedding
    with SwiGLU heads and property-token conditioning. Runs on the device
    its parameters lie on."""

    def _encode(self, tokens: torch.Tensor, tokenizer: TrieTokenizer) -> torch.Tensor:
        return encode_tokens(self._compute, self.config, tokens, tokenizer.stop_token)

    def _to_token(self, h: torch.Tensor) -> torch.Tensor:
        return coati_to_token(self._compute, h)

    def smiles_to_coati_vec(self, smiles, tokenizer: TrieTokenizer) -> np.ndarray:
        """A list of SMILES -> (B, embed_dim) float32 numpy."""
        tokens = [tokenizer.tokenize_text("[SMILES]" + s + "[STOP]", pad=True) for s in smiles]
        return self.encode_tokens(np.asarray(tokens), tokenizer).float().cpu().numpy()

    hcoati_to_2d_batch = InjectedDecoder.vectors_to_2d_batch
    hcoati_to_2d = InjectedDecoder.vector_to_2d
