"""The least time a kernel could take on the inputs a call gave it: the
larger of its needed bytes over the memory rate and its needed operations
over the peak rate of its products' type.

K1 (csrc/decode_attention.cu, int8 cache) reads, for each live row, q and
writes the output (H x Dh each, in the query's type), and reads the
row's int8 K and V over positions [0, pos] with one scale each per
(position, head). Its products are int8 by a float query, counted at the
float32 rate (never the bound). K4 (csrc/egnn_messages_bwd.cu,
bf16-product mode) recomputes the edge MLP and takes three Hm x Hm
products a live pair, 6 Hm^2 + 24 Hm operations; it reads a, c, the
cotangent and writes da, dc (float32, per real atom), reads d2 and w per
pair of real atoms, W2 and the vectors, and writes dW2 and the vectors'
gradients.
"""

from __future__ import annotations

from portbench.costs import HBM_BYTES_PER_S, PEAK_FLOPS


def bound_s(n_bytes: float, n_ops: float, dtype: str) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_FLOPS[dtype])


def k1_int8_bytes(live_rows: float, pos: int, heads: int, dh: int, q_bytes: int = 2,
                  scale_bytes: int = 4) -> float:
    """One launch at position `pos` over `live_rows` rows."""
    return live_rows * heads * ((pos + 1) * (2 * dh + 2 * scale_bytes) + 2 * dh * q_bytes)


def k1_int8_s(live_rows: float, pos: int, heads: int, dh: int, q_bytes: int = 2,
              scale_bytes: int = 4) -> float:
    n_ops = 4.0 * live_rows * heads * (pos + 1) * dh
    return bound_s(k1_int8_bytes(live_rows, pos, heads, dh, q_bytes, scale_bytes), n_ops, "float32")


def k4_s(live_pairs: float, real_atoms: float, real_pairs: float, hm: int) -> float:
    """One launch over a batch with these live pairs, real atoms and pairs
    of real atoms."""
    n_ops = live_pairs * (6.0 * hm * hm + 24.0 * hm)
    n_bytes = 4.0 * (5 * real_atoms * hm + 2 * real_pairs + 2 * hm * hm + 6 * hm)
    return bound_s(n_bytes, n_ops, "bfloat16")
