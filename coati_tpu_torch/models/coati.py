"""COATI composite model: SMILES transformer + point encoder + CLIP heads.

PyTorch counterpart of coati_tpu/models/coati.py: the encoders, the
training forward and the losses. The parameters live in `CoatiModel`, an
nn.Module whose state-dict keys are those of the reference
e3gnn_smiles_clip_e2e ('xformer.*', 'point_encoder.*', 'smiles_to_clip.*',
'point_to_clip.*', 'point_clip_to_special_tokens.*', 'fp_networks.*'), so a
reference state dict loads with load_state_dict(strict=True). The point
encoder runs through models/egnn.py. A fresh `CoatiModel(cfg)` takes
PyTorch's default initialisation of nn.Linear, nn.Embedding and
nn.LayerNorm, which is what coati_tpu's init_coati imitates.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from coati_tpu_torch.models.egnn import N_ONE_HOT, N_TORCH_EMB, EgnnConfig, egnn_forward
from coati_tpu_torch.models.transformer import (
    SmilesTransformer,
    TransformerConfig,
    forward_hidden,
    forward_logits,
    stop_token_hidden,
)
from coati_tpu_torch.ops.layers import cast_floats, layer_norm, linear


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

    @property
    def egnn_config(self) -> EgnnConfig:
        return EgnnConfig(
            hidden_nf=self.n_hidden_e3nn,
            n_layers=self.n_layer_e3gnn,
            message_cutoff=self.msg_cutoff_e3nn if self.honor_msg_cutoff else 5.0,
            instance_norm=True,
            torch_emb=self.torch_emb,
            residual=self.residual,
            dropout=0.0,
            dtype=self.dtype,
            precision=self.precision,
            remat=self.egnn_remat,
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


def encode_points(
    params: CoatiModel, cfg: CoatiConfig, atoms: torch.Tensor, coords: torch.Tensor
) -> torch.Tensor:
    """(B, N), (B, N, 3) -> (B, embed_dim); zeros when the point encoder
    is ablated."""
    encoder = getattr(params, "point_encoder", None)
    if not cfg.use_point_encoder or encoder is None:
        return torch.zeros(
            (atoms.shape[0], cfg.embed_dim),
            dtype=cfg.xformer_config.compute_dtype, device=atoms.device,
        )
    ecfg = cfg.egnn_config
    h = egnn_forward(encoder, ecfg, atoms, coords)
    proj = cast_floats(params.point_to_clip, ecfg.compute_dtype)
    return apply_projection(proj, h, cfg.old_architecture)


def clip_to_special_token(params: CoatiModel, h_clip: torch.Tensor) -> torch.Tensor:
    """SiLU -> Linear token MLP in h_clip's dtype, identity without
    token_mlp."""
    mlp = getattr(params, "point_clip_to_special_tokens", None)
    if mlp is None:
        return h_clip
    lin = cast_floats(mlp, h_clip.dtype)[1]
    return linear(F.silu(h_clip), lin.weight, lin.bias)


def fp_predictions(params: CoatiModel, cfg: CoatiConfig, clip_token: torch.Tensor) -> dict:
    """Fingerprint/descriptor logits from a (post-token-MLP) clip token:
    the heads read the smiles clip token."""
    heads = getattr(params, "fp_networks", None)
    if not heads:
        return {}
    heads = cast_floats(heads, clip_token.dtype)
    return {name: linear(clip_token, head.weight, head.bias) for name, head in heads.items()}


def fp_loss_fn(fp_preds: dict, fp_targets: dict) -> torch.Tensor:
    """Mean BCE-with-logits over all fingerprint heads (binary bits)."""
    total = None
    for name, logits in fp_preds.items():
        y = fp_targets[name].float()
        loss = F.binary_cross_entropy_with_logits(logits.float(), y)
        total = loss if total is None else total + loss
    return total if total is not None else torch.zeros(())


# --------------------------------------------------------------- losses


def cross_entropy_ignore(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -1
) -> torch.Tensor:
    """Mean cross-entropy over labels != ignore_index, in float32; zero
    when every label is ignored."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp_min(1)


def clip_loss(
    smiles_features: torch.Tensor, conformer_features: torch.Tensor, bad_rows: torch.Tensor
) -> torch.Tensor:
    """Symmetric InfoNCE over the batch, in float32; rows flagged in
    bad_rows are no one's label."""
    sf = smiles_features.float()
    cf = conformer_features.float()
    logits = sf @ cf.t()
    n = logits.shape[0]
    labels = torch.where(bad_rows, -1, torch.arange(n, device=logits.device))
    return 0.5 * (cross_entropy_ignore(logits, labels) + cross_entropy_ignore(logits.t(), labels))


def ar_loss_fn(logits: torch.Tensor, y_next: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy with -1-masked labels, averaged over all
    valid tokens of the batch."""
    return cross_entropy_ignore(logits.reshape(-1, logits.shape[-1]), y_next.reshape(-1))


# -------------------------------------------------------------- forward


def _pick_point(
    rows: int,
    p_clip_emb_smi: float,
    device,
    generator: Optional[torch.Generator],
    pick_point: Optional[torch.Tensor],
) -> torch.Tensor:
    """(B, 1) bool: rows whose injected clip token comes from the point
    encoder (probability 1 - p_clip_emb_smi). A given `pick_point` mask is
    used as it is, so that a test can feed two implementations one choice."""
    if pick_point is not None:
        return pick_point.to(device=device, dtype=torch.bool).reshape(rows, 1)
    draws = torch.rand((rows, 1), generator=generator, device=device)
    return draws > p_clip_emb_smi


def _cast_once(params: CoatiModel, cfg: CoatiConfig) -> CoatiModel:
    """The whole model cast to the compute dtype, once per training forward:
    the functions below then find nothing left to cast, and the transformer,
    which runs twice, shares one cast copy (and one cast in the backward)."""
    return cast_floats(params, cfg.xformer_config.compute_dtype)


def _encode_both(params, cfg, generator, raw_tokens, atoms, coords, stop_token,
                 p_clip_emb_smi, pick_point):
    """Both encoders, the two candidate clip tokens and the per-row choice
    between them: (h_e3gnn, h_smiles, smiles_tok, clip_token)."""
    h_e3gnn = encode_points(params, cfg, atoms, coords)
    h_smiles = encode_tokens(params, cfg, raw_tokens, stop_token)
    point_tok = clip_to_special_token(params, h_e3gnn)
    smiles_tok = clip_to_special_token(params, h_smiles)
    pick = _pick_point(h_e3gnn.shape[0], p_clip_emb_smi, h_e3gnn.device, generator, pick_point)
    return h_e3gnn, h_smiles, smiles_tok, torch.where(pick, point_tok, smiles_tok)


def forward(
    params: CoatiModel,
    cfg: CoatiConfig,
    generator: Optional[torch.Generator],
    raw_tokens: torch.Tensor,
    augmented_tokens: torch.Tensor,
    atoms: torch.Tensor,
    coords: torch.Tensor,
    stop_token: int,
    unk_token: int,
    p_clip_emb_smi: float = 0.4,
    pick_point: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training forward: encode both modalities, pick the injected clip
    token per row at random (the point token with probability
    1 - p_clip_emb_smi, drawn from `generator` on the inputs' device unless
    `pick_point` gives the choice), run the decoder with injection.

    Returns (h_e3gnn, h_smiles, logits, bad_rows)."""
    params = _cast_once(params, cfg)
    h_e3gnn, h_smiles, _, clip_token = _encode_both(
        params, cfg, generator, raw_tokens, atoms, coords, stop_token, p_clip_emb_smi, pick_point
    )
    logits = forward_logits(params.xformer, cfg.xformer_config, augmented_tokens, clip_token,
                            unk_token)
    bad_rows = augmented_tokens.sum(dim=-1) < 1
    return h_e3gnn, h_smiles, logits, bad_rows


def forward_fp(
    params: CoatiModel,
    cfg: CoatiConfig,
    generator: Optional[torch.Generator],
    raw_tokens: torch.Tensor,
    augmented_tokens: torch.Tensor,
    atoms: torch.Tensor,
    coords: torch.Tensor,
    stop_token: int,
    unk_token: int,
    p_clip_emb_smi: float = 0.4,
    pick_point: Optional[torch.Tensor] = None,
):
    """Fingerprint-variant training forward: `forward`, and the
    fingerprint logits computed from the smiles clip token.

    Returns (h_e3gnn, h_smiles, logits, bad_rows, fp_preds)."""
    params = _cast_once(params, cfg)
    h_e3gnn, h_smiles, smiles_tok, clip_token = _encode_both(
        params, cfg, generator, raw_tokens, atoms, coords, stop_token, p_clip_emb_smi, pick_point
    )
    fp_preds = fp_predictions(params, cfg, smiles_tok)
    logits = forward_logits(params.xformer, cfg.xformer_config, augmented_tokens, clip_token,
                            unk_token)
    bad_rows = augmented_tokens.sum(dim=-1) < 1
    return h_e3gnn, h_smiles, logits, bad_rows, fp_preds


def tokens_likelihood(
    params: CoatiModel,
    cfg: CoatiConfig,
    tokens: torch.Tensor,
    y_next: torch.Tensor,
    injection: Optional[torch.Tensor] = None,
    unk_token: Optional[int] = None,
) -> torch.Tensor:
    """Summed next-token NLL per row with -1-masked labels, in float32:
    the backbone of hclip_and_tokens_to_likelihood and
    batch_smiles_to_s2s_likelihood."""
    xcfg = cfg.xformer_config
    hidden = forward_hidden(params.xformer, xcfg, tokens, injection, unk_token)
    lm_head = cast_floats(params.xformer.lm_head, xcfg.compute_dtype)
    logp = F.log_softmax(linear(hidden, lm_head.weight).float(), dim=-1)
    valid = y_next != -1
    safe = torch.where(valid, y_next, 0)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum(dim=-1)
