"""E(3)-equivariant point-cloud encoder (EGNN, arXiv:2102.09844 eqs. 3-6).

PyTorch counterpart of coati_tpu/models/egnn.py, as plain functions over
the `PointEncoder` module of models/coati.py (reference e3gnn_clip keys,
weights in PyTorch's (out, in) layout). Messages are computed densely over
all atom pairs with a multiplicative smooth-cutoff mask; the edge MLP's
first layer is decomposed as h_i @ W_a + h_j @ W_b + d^2 * w_c so the
pairwise concat never materializes, and with `fused_messages` the whole
edge MLP and its weighted sum run in the port's message kernel K3, and their
gradient in its backward kernel K4 (ops/kernels/egnn_messages.py), which keep
the (B, N, N, H) tensors out of device memory.

Semantics preserved exactly:
  * cubic smooth cutoff f(d) with f(0)=1, f(cut)=0;
  * NO gradient flows through distances or the cutoff mask (the reference
    builds its neighbor list and distances under no_grad);
  * messages aggregate onto the first pair index (sum over partners), and
    an atom is no partner of itself;
  * per-atom, affine-free normalization over the hidden dim, which is what
    torch InstanceNorm1d computes on the reference's (B, N, H) inputs;
  * coordinates are never updated between layers, so the coord MLP is
    carried only for checkpoint compatibility and never evaluated;
  * masked mean-pool over real atoms with a natoms >= 1 guard.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from coati_tpu_torch.common.periodic_table import xy_one_hot_full_table
from coati_tpu_torch.ops.kernels.egnn_messages import egnn_messages
from coati_tpu_torch.ops.layers import cast_floats, gelu_tanh, instance_norm_lastdim, linear

N_ONE_HOT = 28  # width of the atom one-hot (xpos, 18 + ypos)
N_TORCH_EMB = 84  # rows of the nn.Embedding table when torch_emb
_ONE_HOT_TABLES = {}  # device -> the one-hot table there, copied from the host once


def _one_hot_table(device: torch.device) -> torch.Tensor:
    """The (n_elements, 28) atom one-hot table on `device`. Made once a
    device: a copy from host memory waits for the card, and a training step
    captured as a CUDA graph (training/step_graph.py) may hold no such copy."""
    table = _ONE_HOT_TABLES.get(device)
    if table is None:
        table = _ONE_HOT_TABLES[device] = torch.tensor(xy_one_hot_full_table(), device=device)
    return table


@dataclass(frozen=True)
class EgnnConfig:
    """Field names of coati_tpu's EgnnConfig. `dropout` and `precision` have
    no effect here: no reference config uses dropout, and float32 matmuls run
    in full float32. `remat` recomputes each layer in the backward pass
    (torch.utils.checkpoint) instead of keeping its activations."""

    hidden_nf: int = 128
    n_layers: int = 5
    message_cutoff: float = 5.0
    instance_norm: bool = True
    torch_emb: bool = False
    residual: bool = False
    dropout: float = 0.0
    act_fn: str = "SiLU"
    dtype: str = "float32"
    precision: str = "default"
    remat: bool = True
    # fused message kernels K3 and K4 (need SiLU); otherwise the dense path,
    # which materializes the (B, N, N, H) pairwise tensors
    fused_messages: bool = True

    def replace(self, **changes) -> "EgnnConfig":
        return dataclasses.replace(self, **changes)

    @property
    def in_node_nf(self) -> int:
        return self.hidden_nf if self.torch_emb else N_ONE_HOT

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def _act(cfg: EgnnConfig):
    if cfg.act_fn == "SiLU":
        return F.silu
    if cfg.act_fn == "GELU":
        # coati_tpu's _act calls jax.nn.gelu with its default, the tanh
        # approximation; the port is held to coati_tpu and does the same
        return gelu_tanh
    raise ValueError(f"Bad act_fn {cfg.act_fn}")


def cubic_cutoff(x: torch.Tensor, y: float) -> torch.Tensor:
    """Smooth cutoff: f(0)=1, f'(0)=0, f(y)=0, f'(y)=0."""
    c = (-3.0 / 2.0) * y**-2
    d = 0.5 * y**-3
    val = 1.0 + c * x.square() + d * x**3
    one, zero = torch.ones_like(val), torch.zeros_like(val)
    return torch.where(x <= 0, one, torch.where(x >= y, zero, val))


@torch.no_grad()
def pair_geometry(node_mask: torch.Tensor, coords: torch.Tensor, cutoff: float):
    """(d2, msg_weight), both (B, N, N) in node_mask's dtype and without
    gradient: pairwise squared distances, and the smooth cutoff of the
    distance times the pair mask (both atoms real, and not the same atom).
    Both are computed in float32 and cast last."""
    n = node_mask.shape[1]
    coords = coords.float()
    diff = coords[:, :, None, :] - coords[:, None, :, :]
    d2 = diff.square().sum(dim=-1)
    d = d2.clamp_min(0.0).sqrt()
    not_self = 1.0 - torch.eye(n, dtype=torch.float32, device=coords.device)
    pair_mask = node_mask[:, :, None] * node_mask[:, None, :] * not_self
    msg_weight = cubic_cutoff(d, cutoff) * pair_mask
    return d2.to(node_mask.dtype), msg_weight.to(node_mask.dtype)


def _egnn_layer(
    h: torch.Tensor,  # (B, N, H)
    gcl: nn.Module,  # one e_gcl layer's weights (edge_mlp, node_mlp)
    cfg: EgnnConfig,
    d2: torch.Tensor,  # (B, N, N) squared distances, no gradient
    msg_weight: torch.Tensor,  # (B, N, N) cutoff * pair mask, no gradient
    h0: Optional[torch.Tensor],
) -> torch.Tensor:
    act = _act(cfg)
    hdim = cfg.hidden_nf
    edge1, edge2 = gcl.edge_mlp[0], gcl.edge_mlp[3]

    # edge MLP layer 1, decomposed: concat([h_i, h_j, d^2]) @ W1. The
    # Linear's weight is (H, 2H + 1), the transpose of the JAX matrix.
    w_i = edge1.weight[:, :hdim]
    w_j = edge1.weight[:, hdim : 2 * hdim]
    w_d = edge1.weight[:, 2 * hdim]  # (H,)
    hi = linear(h, w_i)  # (B, N, H)
    hj = linear(h, w_j)
    if cfg.fused_messages and cfg.act_fn == "SiLU":
        # bf16 compute -> bf16 inputs to the kernel's inner product with
        # float32 accumulation; float32 keeps parity numerics
        mi = egnn_messages(
            hi, hj, d2, msg_weight, w_d, edge1.bias, edge2.weight.t(), edge2.bias,
            mm_dtype=cfg.compute_dtype,
        ).to(h.dtype)
    else:
        e1 = act(hi[:, :, None, :] + hj[:, None, :, :] + d2[..., None] * w_d + edge1.bias)
        mij = act(linear(e1, edge2.weight, edge2.bias))  # (B, N, N, H)
        # aggregate messages onto index i, weighted by the smooth cutoff
        mi = torch.einsum("bijh,bij->bih", mij, msg_weight.to(mij.dtype))

    node1, node2 = gcl.node_mlp[0], gcl.node_mlp[3]
    feats = [h, mi] + ([h0] if cfg.residual else [])
    out = linear(torch.cat(feats, dim=-1), node1.weight, node1.bias)
    out = linear(act(out), node2.weight, node2.bias)
    out = h + out  # recurrent=True in all reference configs
    if cfg.instance_norm:
        out = instance_norm_lastdim(out)
    return out


def egnn_forward(
    params: nn.Module,  # the PointEncoder of models/coati.py
    cfg: EgnnConfig,
    atoms: torch.Tensor,  # (B, N) int atomic numbers, 0 = padding
    coords: torch.Tensor,  # (B, N, 3)
) -> torch.Tensor:
    """-> (B, H) masked mean-pooled molecular representation."""
    atoms = atoms.long()
    dtype = cfg.compute_dtype
    params = cast_floats(params, dtype)
    node_mask = (atoms > 0).to(dtype)  # (B, N)

    if cfg.torch_emb:
        nodes = params.emb.weight[atoms]
        h = nodes
    else:
        nodes = _one_hot_table(atoms.device)[atoms].to(dtype)  # (B, N, 28)
        h = linear(nodes, params.embedding.weight, params.embedding.bias)
    if cfg.instance_norm:
        h = instance_norm_lastdim(h)
    h = h.to(dtype)

    d2, msg_weight = pair_geometry(node_mask, coords, cfg.message_cutoff)
    h0 = nodes if cfg.residual else None

    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        gcl = getattr(params, f"gcl_{i}")
        if remat:
            # exact only because a layer draws no random numbers: its recomputation
            # needs no saved RNG state, and reading one is not capture-safe
            # (training/step_graph.py)
            h = checkpoint(_egnn_layer, h, gcl, cfg, d2, msg_weight, h0, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = _egnn_layer(h, gcl, cfg, d2, msg_weight, h0)

    dec1, dec2 = params.node_dec[0], params.node_dec[3]
    h = linear(h, dec1.weight, dec1.bias)
    h = linear(_act(cfg)(h), dec2.weight, dec2.bias)
    h = h * node_mask[..., None]
    natoms = node_mask.sum(dim=-1).clamp_min(1.0)
    return h.sum(dim=1) / natoms[..., None]
