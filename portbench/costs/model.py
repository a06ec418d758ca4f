"""Model FLOPs the inputs need (matrix products only, 2 per multiply-add).

Trunk, per token at position t (0-based) of a layer of width d: the qkv,
output, fc and out products, 24 d^2, and causal attention over t + 1 keys,
4 (t + 1) d. The vocabulary head is 2 d n_tok for each position whose
logits are used. EGNN, per layer: the first edge layer decomposed per atom
(2 products of h^2 for each real atom), the second edge layer 2 h^2 for
each live pair (real atoms, distinct, within the cutoff), the node MLP
2 (2h) h + 2 h^2 per real atom; the embedding 2 * 28 h and the decoder
4 h^2 per real atom. The heads are counted at their widths. A training step
is the forward times 3 (its backward twice the forward); recomputation is
not model work.
"""

from __future__ import annotations

import numpy as np


def trunk_flops(lengths, d: int, n_layer: int) -> float:
    """A full-sequence pass over rows of the given live lengths."""
    lengths = np.asarray(lengths, np.float64)
    # sum over t < L of (24 d^2 + 4 (t + 1) d)
    return float(n_layer * (24.0 * d * d * lengths.sum() + 2.0 * d * (lengths * (lengths + 1)).sum()))


def decode_flops(positions, d: int, n_layer: int, n_tok: int) -> float:
    """One decode step per entry of `positions` (the position each live
    row's step reads up to), each with its vocabulary head."""
    p = np.asarray(positions, np.float64)
    return float(n_layer * (24.0 * d * d * p.size + 4.0 * d * (p + 1).sum()) + 2.0 * d * n_tok * p.size)


def head_flops(cfg: dict) -> float:
    """One row through the projection to the embedding and back to the
    injected token."""
    d = cfg["n_hidden_xformer"]
    if cfg["family"] == "coati2":
        e = cfg["embed_dim"]
        return 2.0 * (d * 2 * e + e * e) + 2.0 * (e * 2 * e + e * e)
    e = cfg["n_embd_common"]
    return 2.0 * d * e + 2.0 * e * d


def egnn_flops(real_atoms: float, live_pairs: float, h: int, n_layer: int) -> float:
    per_layer = 2 * 2.0 * real_atoms * h * h + 2.0 * live_pairs * h * h
    per_layer += 2.0 * real_atoms * 2 * h * h + 2.0 * real_atoms * h * h
    return n_layer * per_layer + 2.0 * real_atoms * 28 * h + 4.0 * real_atoms * h * h


def live_geometry(atoms: np.ndarray, coords: np.ndarray, cutoff: float):
    """(real atoms, live pairs) of a batch: ordered pairs of distinct real
    atoms closer than the cutoff."""
    real = atoms > 0
    diff = coords[:, :, None, :] - coords[:, None, :, :]
    near = (diff * diff).sum(-1) < cutoff * cutoff
    pairs = near & real[:, :, None] & real[:, None, :]
    n = atoms.shape[1]
    pairs &= ~np.eye(n, dtype=bool)[None]
    return int(real.sum()), int(pairs.sum())


def live_length(rows: np.ndarray, stop: int) -> np.ndarray:
    """Tokens up to and with each row's first [STOP] (the whole row
    without one)."""
    has = (rows == stop).any(1)
    return np.where(has, (rows == stop).argmax(1) + 1, rows.shape[1])
