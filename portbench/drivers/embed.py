"""Embeddings of SMILES through the user-facing API: each request is
`rows` corpus SMILES, tokenized and padded to n_seq by the program's
tokenizer, embedded by `encode_tokens`, and returned to the host as
float32. Closed loop, one caller; every request's latency is kept.

Correct: a sample of rows drawn from the seed, with the longest input in
it, against the reference's float32 embeddings (checks.embedding_errors)."""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from portbench import checks, infer
from portbench.costs import PEAK_FLOPS
from portbench.costs import model as flops
from portbench.harness import now, profiled, sync
from portbench.reference.tokenizer import Vocabulary


class State:
    def __init__(self, ctx):
        t = ctx.traffic
        self.model, self.tok = infer.build_model(ctx.cfg, ctx.seed, ctx.device)
        self.pool = infer.RequestPool(infer.load_corpus(t["corpus"]), t["rows"], ctx.seed,
                                      ctx.cfg["n_seq"] - 2)
        self.done = []  # (request index, input token rows, embeddings)

    def call(self, i: int, spans=None):
        smiles = self.pool.smiles(i)
        with spans("tokenize") if spans else nullcontext():
            rows = infer.token_rows(self.tok, smiles)
        h = self.model.encode_tokens(rows, self.tok).float().cpu().numpy()
        if h.shape[0] != len(smiles):
            raise RuntimeError(f"request {i}: {h.shape[0]} rows back for {len(smiles)}")
        return rows, h


def setup(ctx):
    state = State(ctx)
    for w in range(ctx.traffic["warmup_requests"]):
        state.call(-1 - w)
    sync(ctx.device)
    return state


def window(ctx, state):
    ctx.spans.on = True
    opened, i, failed, lat = now(), 0, 0, []
    end = opened
    while i == 0 or now() - opened < ctx.seconds:
        sent = now()
        try:
            rows, h = state.call(i, ctx.spans)
            state.done.append((i, rows, h))
        except RuntimeError:
            failed += 1
        end = now()
        lat.append(end - sent)
        i += 1
    ctx.spans.on = False
    window_s = end - opened
    cfg = ctx.cfg
    stop = state.tok.stop_token
    total = sum(flops.trunk_flops(flops.live_length(r, stop), cfg["n_hidden_xformer"],
                                  cfg["n_layer_xformer"]) + r.shape[0] * flops.head_flops(cfg) / 2
                for _, r, _ in state.done)
    p95 = float(np.percentile(lat, 95)) if len(lat) > 1 else lat[0]
    return {
        "opened": opened, "attempted": i, "failed": failed,
        "metrics": {"infer_mol_per_s": ctx.traffic["rows"] * len(state.done) / window_s,
                    "infer_p95_s": p95},
        "record": {"window_s": window_s, "spans": dict(ctx.spans.seconds), "model_flops": total,
                   "peak_flops": PEAK_FLOPS[cfg["dtype"]],
                   "log": {"requests": len(lat), "median_s": float(np.median(lat)), "p95_s": p95,
                           "max_s": float(max(lat))}},
    }


def traced(ctx, state, record):
    """`traced_requests` requests timed, then the same under the profiler."""
    n = ctx.traffic["traced_requests"]
    sync(ctx.device)
    start = now()
    for i in range(n):
        state.call(i)
    sync(ctx.device)
    wall = now() - start
    with profiled(ctx.device) as out:
        for i in range(n):
            state.call(i)
    record["traced_wall_s"] = wall
    return out[0], wall


def release(ctx, state):
    state.model = None
    torch.cuda.empty_cache() if torch.device(ctx.device).type == "cuda" else None


def readings(ctx, state, q=None):
    """The sampled rows' relative errors: the worst (the number compared)
    and the median."""
    rng = np.random.default_rng(ctx.seed + 2)
    cand = [(j, r) for j, (_, rows, _) in enumerate(state.done) for r in range(rows.shape[0])]
    stop = state.tok.stop_token
    length = np.concatenate([flops.live_length(rows, stop) for _, rows, _ in state.done])
    pick = {int(np.argmax(length))}
    pick |= set(rng.choice(len(cand), size=min(len(cand), ctx.traffic["check_rows"]) - 1,
                           replace=False).tolist())
    pick = sorted(pick)
    smiles = [state.pool.smiles(state.done[cand[j][0]][0])[cand[j][1]] for j in pick]
    got = np.stack([state.done[cand[j][0]][2][cand[j][1]] for j in pick])
    vocab = Vocabulary(ctx.cfg["vocab"])
    w = infer.reference_weights(ctx.cfg, ctx.seed, ctx.device)
    err = checks.embedding_errors(w, ctx.cfg, vocab, smiles, got, ctx.device, q or checks.EXACT)
    return {"embedding_rel_err": float(err.max()), "median_rel_err": float(np.median(err)),
            "rows": len(pick)}
