"""The numbers that decide `correct`, each worked out against the plain
reference (portbench/reference/), and the precision the reference takes
in a cell's control."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model
from portbench.reference.lowp import EXACT, LowPrecision


def control_precision(cfg: dict):
    """One step below what the configuration states: float8 for bfloat16
    products, and int4 for an int8 decode cache."""
    return LowPrecision(kv_bits=4 if cfg.get("kv_cache") == "int8" else None)


def _rows(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _teacher_forced(w: dict, cfg: dict, vocab, smiles: list, served: np.ndarray,
                    prefix_len: int, device, q, block: int):
    """Per block of rows: (the reference's float32 logits over the served
    tokens, its logits under `q` or None, the served token at each
    position, the positions compared). The reference encodes each row's
    SMILES itself (its own tokens, float32), injects the embedding into
    the prompt and reads its logits over the served tokens: position j
    gives the distribution of the token at j + 1. The generated tokens are
    compared up to each row's [STOP]; a [STOP] at a row's last position may
    be forced, and is not compared."""
    width = served.shape[1]
    for a in range(0, len(smiles), block):
        rows = served[a: a + block]
        stop = np.where((rows == vocab.stop).any(1), (rows == vocab.stop).argmax(1), width - 1)
        last = np.where(stop == width - 1, width - 2, stop)  # the last compared position
        src = _rows(vocab.smiles_rows(smiles[a: a + block], cfg["n_seq"]))
        src = src[:, : int((src != vocab.pad).sum(1).max())].to(device)
        toks = _rows(rows[:, : int(last.max())]).to(device)
        exact = model.decode_logits(w, cfg, model.embed(w, cfg, src, vocab.stop), toks,
                                    vocab.unk, prefix_len).float()
        low = None
        if q is not EXACT:
            low = model.decode_logits(w, cfg, model.embed(w, cfg, src, vocab.stop, q), toks,
                                      vocab.unk, prefix_len, q).float()
        served_next = _rows(rows[:, 1: int(last.max()) + 1]).to(device)
        pos = torch.arange(exact.shape[1], device=device)[None, :] + 1  # position of the token
        keep = (pos >= prefix_len) & (pos <= torch.as_tensor(last, device=device)[:, None])
        yield exact, low, served_next, keep


def decode_gaps(w: dict, cfg: dict, vocab, smiles: list, served: np.ndarray, prefix_len: int,
                device, q=EXACT, block: int = 16) -> np.ndarray:
    """The gap, in logits, by which each served greedy token lies below the
    best token of the reference at its position, over every compared
    position of every row. Under a lower precision `q` the gap is that of
    the token `q` puts first."""
    out = []
    for exact, low, served_next, keep in _teacher_forced(w, cfg, vocab, smiles, served,
                                                         prefix_len, device, q, block):
        chosen = served_next if low is None else low.argmax(-1)
        gap = exact.max(-1).values - exact.gather(-1, chosen[..., None])[..., 0]
        out.append(gap[keep].cpu().numpy())
    return np.concatenate(out)


def gap_readings(gaps: np.ndarray) -> dict:
    """The mean gap over every compared token (the number compared), and
    beside it the widest gap and the share of tokens that are not the
    reference's best."""
    return {"mean_logit_gap": float(gaps.mean()), "widest_logit_gap": float(gaps.max()),
            "not_best_share": float((gaps > 0).mean()), "tokens": int(gaps.size)}


def sampled_gaps(w: dict, cfg: dict, vocab, smiles: list, served: np.ndarray, prefix_len: int,
                 device, k: int, inv_temp: float, q=EXACT, seed: int = 0,
                 block: int = 16) -> np.ndarray:
    """For each served token of a top-k request, (observed, expected,
    variance, outside): the gap in logits by which it lies below the
    reference's best token at its position; the mean and the variance of
    that gap under the reference's own sampling distribution there (its k
    best logits times `inv_temp`, softmax); and how far it lies below the
    reference's k-th best logit (0 inside the reference's top k). Under a
    lower precision `q` the token is drawn, from a generator seeded
    `seed`, from the distribution `q`'s logits give."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = []
    for exact, low, served_next, keep in _teacher_forced(w, cfg, vocab, smiles, served,
                                                         prefix_len, device, q, block):
        top, _ = exact[keep].topk(k, dim=-1)  # (n, k), descending
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


def sampled_readings(g: np.ndarray) -> dict:
    """From sampled_gaps: the sum of observed minus expected gaps over its
    standard deviation, in absolute value (about |N(0, 1)| where the tokens
    are drawn from the reference's distribution: a wrong candidate set, a
    wrong index or a wrong temperature moves it by tens), and the widest
    gap below the reference's k-th best."""
    obs, mean, var, outside = g.T
    z = (obs - mean).sum() / max(float(np.sqrt(var.sum())), 1e-12)
    return {"sampled_gap_z": float(abs(z)), "sampled_outside_gap": float(outside.max()),
            "sampled_outside_share": float((outside > 0).mean()),
            "sampled_gap_excess": float((obs - mean).mean()), "sampled_tokens": int(obs.size)}


def embedding_errors(w: dict, cfg: dict, vocab, smiles: list, got: np.ndarray, device, q=EXACT,
                     block: int = 64) -> np.ndarray:
    """For each row: |h - h_ref| / |h_ref|, h_ref the reference's float32
    embedding of the row's SMILES. Under a lower precision `q`, the
    reference computed in it stands in for `got`."""
    out = np.zeros(len(smiles))
    for a in range(0, len(smiles), block):
        src = _rows(vocab.smiles_rows(smiles[a: a + block], cfg["n_seq"]))
        src = src[:, : int((src != vocab.pad).sum(1).max())].to(device)
        ref = model.embed(w, cfg, src, vocab.stop).float()
        h = model.embed(w, cfg, src, vocab.stop, q).float() if q is not EXACT else \
            torch.as_tensor(got[a: a + block], device=device).float()
        out[a: a + block] = ((h - ref).norm(dim=-1) / ref.norm(dim=-1)).cpu().numpy()
    return out


def leaf_gaps(got: dict, ref: dict, keep=None) -> dict:
    """Per leaf, the gap of norms |(|got| - |ref|)| over the larger of |ref|
    and the median leaf's |ref|, over the leaves in `keep` (all by
    default)."""
    names = sorted(keep if keep is not None else ref)
    ref_n = np.array([float(ref[k].double().norm()) for k in names])
    got_n = np.array([float(got[k].double().norm()) for k in names])
    gaps = np.abs(got_n - ref_n) / np.maximum(ref_n, np.median(ref_n))
    return dict(zip(names, gaps.tolist()))


def moved_leaves(first_grad: dict) -> list:
    """Leaves whose gradient the reference finds to be more than rounding:
    a norm at least a thousandth of the median leaf's."""
    norms = {k: float(v.double().norm()) for k, v in first_grad.items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    return [k for k, v in norms.items() if v >= floor]
