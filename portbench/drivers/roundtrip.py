"""Round trips of SMILES through the user-facing API: each request is
`rows` corpus SMILES, tokenized by the program's tokenizer, embedded and
decoded back by `smiles_to_2d_batch` (top-k sampling; every
`greedy_every`-th request greedy, k 1), with the SMILES on the host at the
end. Closed loop, one caller.

Correct: samples of rows drawn from the seed, each with its kind's longest
row in it, against the reference's logits over the same tokens. The greedy
requests' rows: the mean gap of a served token below the reference's best
(checks.decode_gaps; precision). The top-k requests' rows: how far the
served tokens' gaps below the reference's best stray from what the
reference's own top-k, inverse-temperature distribution expects, and the
widest gap below its k-th best (checks.sampled_gaps; the candidates, the
temperature and the draw)."""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from portbench import checks, infer
from portbench.costs import PEAK_FLOPS, kernels
from portbench.costs import model as flops
from portbench.harness import now, profiled, sync
from portbench.reference.tokenizer import Vocabulary

PREFIX = "[CLIP][UNK][SMILES]"


def _k1():
    from coati_tpu_torch.ops.kernels.decode_attention import decode_attention_quant

    return decode_attention_quant


class State:
    def __init__(self, ctx):
        t = ctx.traffic
        self.model, self.tok = infer.build_model(ctx.cfg, ctx.seed, ctx.device)
        self.rec = infer.RecordingTokenizer(self.tok)
        self.pool = infer.RequestPool(infer.load_corpus(t["corpus"]), t["rows"], ctx.seed,
                                      ctx.cfg["n_seq"] - 2)
        self.prefix_len = len(self.tok.tokenize_text(PREFIX, pad=False))
        self.done = []  # (request index, greedy, input token rows, served rows)

    def greedy(self, ctx, i: int) -> bool:
        every = ctx.traffic["greedy_every"]
        return i % every == every - 1

    def call(self, ctx, model, i: int, spans=None):
        """One request; returns (input rows, served rows)."""
        smiles = self.pool.smiles(i)
        k = 1 if self.greedy(ctx, i) else ctx.traffic["k"]
        with spans("tokenize") if spans else nullcontext():
            rows = infer.token_rows(self.tok, smiles)
        out = model.smiles_to_2d_batch(rows, self.rec, k=k, inv_temp=ctx.traffic["inv_temp"])
        if len(out) != len(smiles) or not all(isinstance(s, str) for s in out):
            raise RuntimeError(f"request {i}: {len(out)} rows back for {len(smiles)}")
        return rows, self.rec.last


def setup(ctx):
    state = State(ctx)
    # one request of each kind the traffic sends (greedy, then sampled),
    # from draws the window does not reach first
    for w in range(min(2, ctx.traffic["greedy_every"])):
        state.call(ctx, state.model, -1 - w)
    sync(ctx.device)
    return state


def _live_positions(served: np.ndarray, stop: int, prefix_len: int):
    """For each row the positions its useful decode steps read up to: from
    the prefix to the step before its [STOP]."""
    width = served.shape[1]
    ends = np.where((served == stop).any(1), (served == stop).argmax(1), width - 1)
    return [np.arange(prefix_len, e) for e in ends]


def request_flops(cfg: dict, rows: np.ndarray, served: np.ndarray, stop: int,
                  prefix_len: int) -> float:
    d, n, v = cfg["n_hidden_xformer"], cfg["n_layer_xformer"], cfg["n_tok"]
    total = flops.trunk_flops(flops.live_length(rows, stop), d, n)
    total += rows.shape[0] * (flops.head_flops(cfg) + flops.trunk_flops([prefix_len], d, n)
                              + 2.0 * d * v)
    pos = np.concatenate(_live_positions(served, stop, prefix_len))
    return total + flops.decode_flops(pos, d, n, v)


def k1_needed_s(cfg: dict, served: np.ndarray, stop: int, prefix_len: int) -> float:
    ends = [len(p) + prefix_len for p in _live_positions(served, stop, prefix_len)]
    ends = np.asarray(ends)
    h = cfg["n_head"]
    dh = cfg["n_hidden_xformer"] // h
    total = 0.0
    for pos in range(prefix_len, int(ends.max())):
        live = int((ends > pos).sum())
        total += kernels.k1_int8_s(live, pos, h, dh)
    return cfg["n_layer_xformer"] * total


def window(ctx, state):
    k1 = _k1()
    launches0 = k1.launches
    ctx.spans.on = True
    opened, i, failed, ends, log = now(), 0, 0, [], []
    # the window also runs on until a request of each kind, which the check
    # reads, is done
    while now() - opened < ctx.seconds or len({g for _, g, _, _ in state.done}) < 2:
        sent, before = now(), k1.launches
        try:
            rows, served = state.call(ctx, state.model, i, ctx.spans)
            state.done.append((i, state.greedy(ctx, i), rows, served))
        except RuntimeError:
            failed += 1
        ends.append(now())
        log.append([round(ends[-1] - sent, 5), (k1.launches - before) // ctx.cfg["n_layer_xformer"],
                    int(state.greedy(ctx, i))])
        i += 1
    ctx.spans.on = False
    window_s = ends[-1] - opened
    stop, p = state.tok.stop_token, state.prefix_len
    steps = (k1.launches - launches0) / ctx.cfg["n_layer_xformer"]
    useful = sum(sum(len(x) for x in _live_positions(s, stop, p)) for _, _, _, s in state.done)
    total = sum(request_flops(ctx.cfg, r, s, stop, p) for _, _, r, s in state.done)
    mols = ctx.traffic["rows"] * len(state.done)
    return {
        "opened": opened, "attempted": i, "failed": failed,
        "metrics": {"infer_mol_per_s": mols / window_s},
        "record": {"window_s": window_s, "spans": dict(ctx.spans.seconds),
                   "live_row_steps": useful, "row_steps": ctx.traffic["rows"] * steps,
                   "model_flops": total, "peak_flops": PEAK_FLOPS[ctx.cfg["dtype"]],
                   "log": {"requests_seconds_steps_greedy": log}},
    }


def traced(ctx, state, record):
    """One sampled request timed, then the same request (the same draws)
    under the profiler."""
    k1 = _k1()
    seed = ctx.seed + 1
    sync(ctx.device)
    start = now()
    state.call(ctx, infer.same_model(state.model, seed), 0)
    sync(ctx.device)
    wall = now() - start
    launches0 = k1.launches
    with profiled(ctx.device) as out:
        _, served = state.call(ctx, infer.same_model(state.model, seed), 0)
    trace = out[0]
    steps = (k1.launches - launches0) / ctx.cfg["n_layer_xformer"]
    record.update({
        "traced_wall_s": wall, "traced_decode_steps": steps,
        "k1_needed_s": k1_needed_s(ctx.cfg, served, state.tok.stop_token, state.prefix_len),
    })
    return trace, wall


def release(ctx, state):
    state.model = state.rec = None
    torch.cuda.empty_cache() if torch.device(ctx.device).type == "cuda" else None


def sample(ctx, state, greedy: bool, rows: int):
    """(SMILES, served rows) of the rows the check reads among the requests
    of one kind: the longest row and `rows` - 1 more drawn from the seed."""
    done = [(i, s) for i, g, _, s in state.done if g == greedy]
    if not done:
        return [], np.zeros((0, 0), np.int64)
    stop = state.tok.stop_token
    cand = [(i, r) for i, s in done for r in range(s.shape[0])]
    served = dict(done)
    length = [flops.live_length(served[i][r: r + 1], stop)[0] for i, r in cand]
    rng = np.random.default_rng(ctx.seed + 2 + int(greedy))
    pick = {int(np.argmax(length))}
    pick |= set(rng.choice(len(cand), size=min(len(cand), rows) - 1, replace=False).tolist())
    pick = sorted(pick)[:rows]
    smiles = [state.pool.smiles(cand[j][0])[cand[j][1]] for j in pick]
    return smiles, np.stack([served[cand[j][0]][cand[j][1]] for j in pick])


def readings(ctx, state, q=None):
    """The numbers `correct` can compare: the sampled greedy rows' logit
    gaps below the reference's best, and the sampled top-k rows' gaps
    against the reference's top-k distribution (under `q`, the control's:
    its first token, and a token drawn from its own distribution)."""
    t = ctx.traffic
    vocab = Vocabulary(ctx.cfg["vocab"])
    w = infer.reference_weights(ctx.cfg, ctx.seed, ctx.device)
    out = {}
    smiles, served = sample(ctx, state, True, t["check_rows"])
    if smiles:
        gaps = checks.decode_gaps(w, ctx.cfg, vocab, smiles, served, state.prefix_len,
                                  ctx.device, q or checks.EXACT)
        out.update(checks.gap_readings(gaps), greedy_rows=len(smiles))
    smiles, served = sample(ctx, state, False, t["check_rows_sampled"])
    if smiles:
        g = checks.sampled_gaps(w, ctx.cfg, vocab, smiles, served, state.prefix_len, ctx.device,
                                t["k"], t["inv_temp"], q or checks.EXACT, ctx.seed + 4)
        out.update(checks.sampled_readings(g), sampled_rows=len(smiles))
    return out
