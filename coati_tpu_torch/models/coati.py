"""COATI composite model: SMILES transformer + point encoder + CLIP heads.

PyTorch counterpart of coati_tpu/models/coati.py, inference half. The
parameters live in `CoatiModel`, an nn.Module whose state-dict keys are
those of the reference e3gnn_smiles_clip_e2e ('xformer.*',
'point_encoder.*', 'smiles_to_clip.*', 'point_to_clip.*',
'point_clip_to_special_tokens.*', 'fp_networks.*'), so a reference state
dict loads with load_state_dict(strict=True). The point encoder's weights
are loaded and kept; running it (the EGNN and its kernel) is a later slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from coati_tpu_torch.models.transformer import (
    SmilesTransformer,
    TransformerConfig,
    forward_hidden,
    stop_token_hidden,
)
from coati_tpu_torch.ops.layers import cast_floats, layer_norm, linear

N_ONE_HOT = 28  # point-encoder atom one-hot width (coati_tpu/models/egnn.py)
N_TORCH_EMB = 84  # rows of the point encoder's nn.Embedding table when torch_emb


@dataclass(frozen=True)
class CoatiConfig:
    """Field names of coati_tpu's CoatiConfig (and of the reference
    constructor kwargs), so stored model_kwargs map 1:1."""

    n_layer_e3gnn: int = 4
    n_layer_xformer: int = 16
    n_hidden_xformer: int = 128
    n_hidden_e3nn: int = 128
    msg_cutoff_e3nn: float = 4.0
    n_embd_common: int = 128
    n_head: int = 8
    n_seq: int = 200
    n_tok: int = 4
    biases: bool = True
    torch_emb: bool = False
    residual: bool = False
    norm_clips: bool = True
    norm_embed: bool = False
    token_mlp: bool = True
    use_point_encoder: bool = True
    old_architecture: bool = False
    fp_map: Optional[tuple] = None  # e.g. (("morgan", 2048),)
    honor_msg_cutoff: bool = False
    dtype: str = "float32"
    precision: str = "default"
    kv_dtype: str = "auto"
    kv_scale_dtype: str = "float32"
    decode_kernel: str = "xla"
    prefill_kernel: str = "auto"
    topk_recall: float = 0.8
    remat: bool = False
    egnn_remat: bool = True
    softmax_dtype: str = "float32"

    def replace(self, **changes) -> "CoatiConfig":
        return dataclasses.replace(self, **changes)

    @property
    def embed_dim(self) -> int:
        return self.n_embd_common

    @property
    def xformer_config(self) -> TransformerConfig:
        return TransformerConfig(
            n_layer=self.n_layer_xformer,
            n_embd=self.n_hidden_xformer,
            n_head=self.n_head,
            n_seq=self.n_seq,
            n_tok=self.n_tok,
            biases=self.biases,
            norm_embed=self.norm_embed,
            dtype=self.dtype,
            precision=self.precision,
            kv_dtype=self.kv_dtype,
            kv_scale_dtype=self.kv_scale_dtype,
            decode_kernel=self.decode_kernel,
            prefill_kernel=self.prefill_kernel,
            topk_recall=self.topk_recall,
            remat=self.remat,
            softmax_dtype=self.softmax_dtype,
        )


# ------------------------------------------------------------ parameters


class _Gcl(nn.Module):
    """One e_gcl layer's weights; Sequential indices as the reference's
    (Linears at 0/3 of the edge and node MLPs, 0/2 of the coord MLP)."""

    def __init__(self, h: int, node_in: int):
        super().__init__()
        self.edge_mlp = nn.Sequential(nn.Linear(2 * h + 1, h), nn.SiLU(), nn.Identity(), nn.Linear(h, h))
        self.node_mlp = nn.Sequential(nn.Linear(node_in, h), nn.SiLU(), nn.Identity(), nn.Linear(h, h))
        self.coord_mlp = nn.Sequential(nn.Linear(h, h), nn.SiLU(), nn.Linear(h, 1, bias=False))


class PointEncoder(nn.Module):
    """Weights of the EGNN point encoder (reference e3gnn_clip keys)."""

    def __init__(self, cfg: CoatiConfig):
        super().__init__()
        h = cfg.n_hidden_e3nn
        in_node = h if cfg.torch_emb else N_ONE_HOT
        if cfg.torch_emb:
            self.emb = nn.Embedding(N_TORCH_EMB, h)
        else:
            self.embedding = nn.Linear(N_ONE_HOT, h)
        node_in = 2 * h + (in_node if cfg.residual else 0)
        for i in range(cfg.n_layer_e3gnn):
            self.add_module(f"gcl_{i}", _Gcl(h, node_in))
        self.node_dec = nn.Sequential(nn.Linear(h, h), nn.SiLU(), nn.Identity(), nn.Linear(h, h))


def _projection(cfg: CoatiConfig, d_in: int, ln_dim: int) -> nn.Module:
    """LayerNorm+Linear head: LN first (new architecture) or last (old);
    a bare Linear without norm_clips."""
    lin = nn.Linear(d_in, cfg.embed_dim)
    if not cfg.norm_clips:
        return lin
    if cfg.old_architecture:
        return nn.Sequential(lin, nn.LayerNorm(ln_dim))
    return nn.Sequential(nn.LayerNorm(ln_dim), lin)


class CoatiModel(nn.Module):
    """Parameters of the composite model, under the reference's keys."""

    def __init__(self, cfg: CoatiConfig):
        super().__init__()
        self.xformer = SmilesTransformer(cfg.xformer_config)
        if cfg.use_point_encoder:
            self.point_encoder = PointEncoder(cfg)
            # REFERENCE QUIRK: the point head LayerNorm is over hidden_nf
            self.point_to_clip = _projection(cfg, cfg.n_hidden_e3nn, cfg.n_hidden_e3nn)
        self.smiles_to_clip = _projection(cfg, cfg.n_hidden_xformer, cfg.embed_dim)
        if cfg.token_mlp:
            self.point_clip_to_special_tokens = nn.Sequential(
                nn.SiLU(), nn.Linear(cfg.embed_dim, cfg.embed_dim)
            )
        if cfg.fp_map:
            self.fp_networks = nn.ModuleDict(
                {name: nn.Linear(cfg.embed_dim, n_bits) for name, n_bits in cfg.fp_map}
            )


def apply_projection(p: nn.Module, x: torch.Tensor, old_architecture: bool) -> torch.Tensor:
    if isinstance(p, nn.Linear):
        return linear(x, p.weight, p.bias)
    if old_architecture:
        lin, ln = p[0], p[1]
        return layer_norm(linear(x, lin.weight, lin.bias), ln.weight, ln.bias)
    ln, lin = p[0], p[1]
    return linear(layer_norm(x, ln.weight, ln.bias), lin.weight, lin.bias)


# ------------------------------------------------------------- encoders


def encode_tokens(
    params: CoatiModel, cfg: CoatiConfig, tokens: torch.Tensor, stop_token: int
) -> torch.Tensor:
    """(B, T) -> (B, embed_dim): hclip of the [STOP] hidden state."""
    xcfg = cfg.xformer_config
    hidden = forward_hidden(params.xformer, xcfg, tokens)
    h = stop_token_hidden(hidden, tokens, stop_token)
    proj = cast_floats(params.smiles_to_clip, xcfg.compute_dtype)
    return apply_projection(proj, h, cfg.old_architecture)


def clip_to_special_token(params: CoatiModel, h_clip: torch.Tensor) -> torch.Tensor:
    """SiLU -> Linear token MLP, identity without token_mlp."""
    mlp = getattr(params, "point_clip_to_special_tokens", None)
    if mlp is None:
        return h_clip
    lin = mlp[1]
    return linear(F.silu(h_clip), lin.weight, lin.bias)
