"""The round trips' numbers of `correct` (checks.decode_gaps and
checks.sampled_gaps) for any pair of reference functions: `embed(a, b, q)`
gives the reference's embeddings of the compared rows a to b (from their
SMILES, their points, ...), `decode(h, tokens, q)` its teacher-forced
logits behind them. Used by the drivers whose model or input the
functions of checks.py do not take (roundtrip_mla, roundtrip_points)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.lowp import EXACT


def _rows(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def teacher_forced(embed, decode, stop: int, served: np.ndarray, prefix_len: int, device, q,
                   block: int):
    """Per block of rows: (the reference's float32 logits over the served
    tokens, its logits under `q` or None, the served token at each position,
    the positions compared), as checks._teacher_forced gives them."""
    width = served.shape[1]
    for a in range(0, served.shape[0], block):
        rows = served[a: a + block]
        end = np.where((rows == stop).any(1), (rows == stop).argmax(1), width - 1)
        last = np.where(end == width - 1, width - 2, end)  # the last compared position
        toks = _rows(rows[:, : int(last.max())]).to(device)
        exact = decode(embed(a, a + len(rows), EXACT), toks, EXACT).float()
        low = None if q is EXACT else decode(embed(a, a + len(rows), q), toks, q).float()
        served_next = _rows(rows[:, 1: int(last.max()) + 1]).to(device)
        pos = torch.arange(exact.shape[1], device=device)[None, :] + 1
        keep = (pos >= prefix_len) & (pos <= torch.as_tensor(last, device=device)[:, None])
        yield exact, low, served_next, keep


def decode_gaps(embed, decode, stop: int, served, prefix_len: int, device, q=EXACT,
                block: int = 16) -> np.ndarray:
    """checks.decode_gaps over the reference functions given."""
    out = []
    for exact, low, served_next, keep in teacher_forced(embed, decode, stop, served, prefix_len,
                                                        device, q, block):
        chosen = served_next if low is None else low.argmax(-1)
        gap = exact.max(-1).values - exact.gather(-1, chosen[..., None])[..., 0]
        out.append(gap[keep].cpu().numpy())
    return np.concatenate(out)


def sampled_gaps(embed, decode, stop: int, served, prefix_len: int, device, k: int,
                 inv_temp: float, q=EXACT, seed: int = 0, block: int = 16) -> np.ndarray:
    """checks.sampled_gaps over the reference functions given."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = []
    for exact, low, served_next, keep in teacher_forced(embed, decode, stop, served, prefix_len,
                                                        device, q, block):
        top, _ = exact[keep].topk(k, dim=-1)
        if low is None:
            chosen = served_next[keep]
        else:
            vals, idx = low[keep].topk(k, dim=-1)
            draw = torch.multinomial(torch.softmax(vals * inv_temp, -1), 1, generator=gen)
            chosen = idx.gather(-1, draw)[:, 0]
        logit = exact[keep].gather(-1, chosen[:, None])[:, 0]
        best = top[:, 0]
        p = torch.softmax(top * inv_temp, dim=-1)
        gaps = best[:, None] - top
        mean = (p * gaps).sum(-1)
        var = (p * gaps.square()).sum(-1) - mean.square()
        outside = (top[:, -1] - logit).clamp_min(0)
        out.append(torch.stack([best - logit, mean, var.clamp_min(0), outside], 1).cpu().numpy())
    return np.concatenate(out).astype(np.float64)
