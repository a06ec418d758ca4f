"""COATI's point encoder, plain: an E(n)-equivariant GNN (arXiv:2102.09844
eqs. 3-6) over all atom pairs, without coordinate updates.

Atoms are featurized as a 28-wide one-hot of the element's (x, 18 + y)
position in the periodic table (row 0, the padding element, has x = y =
-1), embedded by a Linear and normalized per atom over the hidden width
(affine-free, biased variance). Each layer computes for every ordered pair
of distinct real atoms within the cutoff the message
silu(silu([h_i, h_j, d_ij^2] W1 + b1) W2 + b2), weighted by the cubic
cutoff f(d) = 1 - 1.5 (d / c)^2 + 0.5 (d / c)^3 (0 beyond c), summed onto
atom i; the node update is h + silu([h, m] V1 + c1) V2 + c2, normalized
per atom again. Distances carry no gradient. The decoder is
silu(h D1 + e1) D2 + e2, mean-pooled over real atoms. COATI's model ignores
its recipe's cutoff and uses 5 Angstrom (the reference implementation's
quirk; a configuration states the cutoff in use).
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.lowp import EXACT, matmul

TABLE = Path(__file__).resolve().parents[2] / "coati_tpu_torch" / "common" / "periodic_table.json"
LN_EPS = 1e-5


@lru_cache(maxsize=None)
def _one_hot_rows():
    elements = json.loads(TABLE.read_text())
    max_x = max(e["xpos"] for e in elements)
    width = max_x + max(e["ypos"] for e in elements)
    rows = []
    for e in elements:
        row = [0.0] * width
        row[e["xpos"]] = 1.0  # -1 for the padding element: the last column
        if max_x + e["ypos"] < width:
            row[max_x + e["ypos"]] = 1.0
        rows.append(row)
    return rows


def _atom_norm(x):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + LN_EPS)


def pair_geometry(atoms: torch.Tensor, coords: torch.Tensor, cutoff: float):
    """(d2, weight), each (B, N, N): squared distances and the cutoff times
    the mask of pairs of distinct real atoms."""
    mask = (atoms > 0).float()
    with torch.no_grad():
        d2 = (coords[:, :, None, :] - coords[:, None, :, :]).square().sum(-1)
        d = d2.clamp_min(0).sqrt()
        f = 1.0 - 1.5 * (d / cutoff) ** 2 + 0.5 * (d / cutoff) ** 3
        f = torch.where(d >= cutoff, torch.zeros_like(f), f)
        eye = torch.eye(atoms.shape[1], device=atoms.device)
        weight = f * mask[:, :, None] * mask[:, None, :] * (1 - eye)
    return d2, weight


def _layer(h, lw: dict, i: int, d2, weight, q):
    hdim = h.shape[-1]
    w1 = lw["edge_w1"][i]
    hi = matmul(h, w1[:hdim], None, q)
    hj = matmul(h, w1[hdim: 2 * hdim], None, q)
    e1 = F.silu(hi[:, :, None, :] + hj[:, None, :, :] + d2[..., None] * w1[2 * hdim]
                + lw["edge_b1"][i])
    msg = F.silu(matmul(e1, lw["edge_w2"][i], lw["edge_b2"][i], q))
    mi = torch.einsum("bijh,bij->bih", msg, weight)
    out = matmul(torch.cat([h, mi], dim=-1), lw["node_w1"][i], lw["node_b1"][i], q)
    out = matmul(F.silu(out), lw["node_w2"][i], lw["node_b2"][i], q)
    return q.store(_atom_norm(h + out))


def encode_points(pe: dict, atoms: torch.Tensor, coords: torch.Tensor, cutoff: float, q=EXACT,
                  remat: bool = False) -> torch.Tensor:
    """(B, N) atomic numbers (0 = padding), (B, N, 3) -> (B, hidden)
    pooled; `remat` recomputes each layer's pairs in the backward pass."""
    table = torch.tensor(_one_hot_rows(), device=atoms.device)
    h = q.store(_atom_norm(matmul(table[atoms.long()], pe["embed_w"], pe["embed_b"], q)))
    d2, weight = pair_geometry(atoms, coords.float(), cutoff)
    lw = pe["layers"]
    for i in range(lw["edge_w1"].shape[0]):
        if remat and torch.is_grad_enabled():
            h = checkpoint(_layer, h, lw, i, d2, weight, q, use_reentrant=False)
        else:
            h = _layer(h, lw, i, d2, weight, q)
    h = matmul(F.silu(matmul(h, pe["dec_w1"], pe["dec_b1"], q)), pe["dec_w2"], pe["dec_b2"], q)
    mask = (atoms > 0).float()
    return (h * mask[..., None]).sum(1) / mask.sum(-1).clamp_min(1.0)[..., None]
