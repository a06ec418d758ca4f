"""Analytic model-FLOP counts for the COATI train step.

Own copy of coati_tpu/training/flops.py. These formulas count the matmul
FLOPs of the compute graph (models/transformer.py `_block_full`,
models/egnn.py `_egnn_layer`); elementwise work is excluded, per standard
MFU accounting.

MFU convention: model FLOPs = 3x the forward matmul FLOPs (backward
costs ~2x forward). Rematerialized recompute is real executed work but
NOT model work, so it never enters the numerator.
"""

from __future__ import annotations


def transformer_pass_flops(
    n_layer: int,
    d: int,
    batch: int,
    seq: int,
    *,
    n_tok: int = 0,
    logits: bool = False,
) -> float:
    """Forward matmul FLOPs of one full-sequence trunk pass.

    Per token per block (_block_full): qkv (3d^2), attn out proj (d^2),
    fc (4d^2), out (4d^2) -> 12 d^2 MACs = 24 d^2 FLOPs; attention
    scores q@k^T and probs@v are each T*d MACs per token -> 4*T*d FLOPs.
    Optional logits head: d x n_tok per token.
    """
    per_tok = n_layer * (24.0 * d * d + 4.0 * seq * d)
    if logits:
        per_tok += 2.0 * d * n_tok
    return batch * seq * per_tok


def egnn_pass_flops(
    n_layers: int,
    h: int,
    batch: int,
    natoms: int,
    *,
    in_node_nf: int = 28,  # N_ONE_HOT of models/egnn.py
    residual: bool = False,
) -> float:
    """Forward matmul FLOPs of one EGNN encoder pass (_egnn_layer +
    embed/decoder linears in egnn_forward).

    Per layer: hi/hj decompositions 2 * (B N H^2 MACs), the pairwise
    edge-MLP matmul e1 @ W2 (B N^2 H^2 MACs — the dominant term, also
    inside the fused message kernel), node MLP over concat([h, mi]):
    2H->H then H->H (3 B N H^2 MACs; residual appends the raw
    in_node_nf-wide embedding input h0 to the concat). Embed:
    in_node_nf->H; decoder: H->H twice. The
    message-aggregation einsum (B N^2 H MACs, H-fold below the pairwise
    matmul) is excluded with the elementwise work.
    `natoms` is the PADDED bucket size: the dense path always pays it,
    and the fused kernel's dynamic bounds only skip work that model
    accounting would also skip — use the bucket for a conservative MFU.
    """
    n_in = 2 * h + (in_node_nf if residual else 0)  # node-MLP concat width
    per_layer = (
        2.0 * 2 * batch * natoms * h * h  # hi, hj
        + 2.0 * batch * natoms * natoms * h * h  # pairwise e1 @ W2
        + 2.0 * batch * natoms * n_in * h  # node_w1
        + 2.0 * batch * natoms * h * h  # node_w2
    )
    embed = 2.0 * batch * natoms * in_node_nf * h
    dec = 2.0 * 2 * batch * natoms * h * h
    return n_layers * per_layer + embed + dec


def coati_train_step_model_flops(
    *,
    n_layer_xformer: int,
    n_hidden_xformer: int,
    n_layer_e3gnn: int,
    n_hidden_e3nn: int,
    n_tok: int,
    batch: int,
    seq: int,
    natoms: int,
) -> float:
    """fwd+bwd model FLOPs of one CLIP-e2e train step (models/coati.py
    forward: trunk encode pass + trunk AR pass with logits + one EGNN
    pass; clip/unembed projections are < 0.5% and folded into logits)."""
    fwd = (
        transformer_pass_flops(n_layer_xformer, n_hidden_xformer, batch, seq)
        + transformer_pass_flops(
            n_layer_xformer, n_hidden_xformer, batch, seq,
            n_tok=n_tok, logits=True,
        )
        + egnn_pass_flops(n_layer_e3gnn, n_hidden_e3nn, batch, natoms)
    )
    return 3.0 * fwd
