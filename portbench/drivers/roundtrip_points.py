"""Round trips of 3D point clouds through the user-facing API: each request
is the `rows` molecules of the points fixture (atoms and conformer
coordinates, N padded to 128), in an order drawn from the seed, embedded by
the EGNN point encoder and decoded to SMILES by `points_to_2d_batch` (top-k
sampling; every `greedy_every`-th request greedy, k 1), with the SMILES on
the host at the end. Closed loop, one caller.

Correct: as `roundtrip`, with the reference embedding each compared
molecule from its points (reference/egnn.py and the point head) and
reading its logits over the served tokens (reference/model.decode_logits):
the greedy rows' mean gap below the reference's best, the top-k rows' |z|
and widest gap below its k-th best (teacher.py)."""

from __future__ import annotations

import numpy as np
import torch

from portbench import checks, harness, infer, teacher
from portbench.costs import PEAK_FLOPS
from portbench.costs import model as flops
from portbench.harness import ROOT, now, profiled, sync
from portbench.reference import egnn, model
from portbench.reference.tokenizer import Vocabulary

PREFIX = "[CLIP][UNK][SMILES]"

_roundtrip = harness.driver("roundtrip")


class State:
    def __init__(self, ctx):
        t = ctx.traffic
        self.model, self.tok = infer.build_model(ctx.cfg, ctx.seed, ctx.device)
        self.rec = infer.RecordingTokenizer(self.tok)
        fixture = np.load(ROOT / t["fixture"])
        rows = t["rows"]
        self.atoms = fixture["atoms"][:rows].astype(np.int64)
        self.coords = fixture["coords"][:rows].astype(np.float32)
        self.order = np.random.default_rng(ctx.seed).permutation(len(self.atoms))
        self.prefix_len = len(self.tok.tokenize_text(PREFIX, pad=False))
        self.geometry = flops.live_geometry(self.atoms, self.coords, ctx.cfg["egnn_cutoff"])
        self.done = []  # (request index, greedy, fixture indices, served rows)

    def indices(self, i: int) -> np.ndarray:
        """The fixture rows of request i, in its order."""
        return np.roll(self.order, 37 * i)

    def greedy(self, ctx, i: int) -> bool:
        every = ctx.traffic["greedy_every"]
        return i % every == every - 1

    def call(self, ctx, handle, i: int):
        """One request; returns (fixture indices, served rows)."""
        idx = self.indices(i)
        k = 1 if self.greedy(ctx, i) else ctx.traffic["k"]
        out = handle.points_to_2d_batch(self.atoms[idx], self.coords[idx], self.rec, k=k,
                                        inv_temp=ctx.traffic["inv_temp"])
        if len(out) != len(idx) or not all(isinstance(s, str) for s in out):
            raise RuntimeError(f"request {i}: {len(out)} rows back for {len(idx)}")
        return idx, self.rec.last


def setup(ctx):
    state = State(ctx)
    # one request of each kind (greedy, then sampled); the second use of the
    # shape captures the decode graph
    for w in range(min(2, ctx.traffic["greedy_every"])):
        state.call(ctx, state.model, -1 - w)
    sync(ctx.device)
    return state


def request_flops(ctx, state, served: np.ndarray) -> float:
    cfg, stop, p = ctx.cfg, state.tok.stop_token, state.prefix_len
    d, n, v = cfg["n_hidden_xformer"], cfg["n_layer_xformer"], cfg["n_tok"]
    h, e = cfg["n_hidden_e3nn"], cfg["n_embd_common"]
    real, pairs = state.geometry
    total = flops.egnn_flops(real, pairs, h, cfg["n_layer_e3gnn"])
    total += served.shape[0] * (2.0 * h * e + 2.0 * e * d + flops.trunk_flops([p], d, n)
                                + 2.0 * d * v)
    pos = np.concatenate(_roundtrip._live_positions(served, stop, p))
    return total + flops.decode_flops(pos, d, n, v)


def window(ctx, state):
    k1 = _roundtrip._k1()
    n_layer = ctx.cfg["n_layer_xformer"]
    launches0 = k1.launches
    opened, i, failed, ends, log = now(), 0, 0, [], []
    while now() - opened < ctx.seconds or len({g for _, g, _, _ in state.done}) < 2:
        sent, before = now(), k1.launches
        try:
            idx, served = state.call(ctx, state.model, i)
            state.done.append((i, state.greedy(ctx, i), idx, served))
        except RuntimeError:
            failed += 1
        ends.append(now())
        log.append([round(ends[-1] - sent, 5), (k1.launches - before) // n_layer,
                    int(state.greedy(ctx, i))])
        i += 1
    window_s = ends[-1] - opened
    stop, p = state.tok.stop_token, state.prefix_len
    steps = (k1.launches - launches0) / n_layer
    useful = sum(sum(len(x) for x in _roundtrip._live_positions(s, stop, p))
                 for _, _, _, s in state.done)
    total = sum(request_flops(ctx, state, s) for _, _, _, s in state.done)
    rows = ctx.traffic["rows"]
    return {
        "opened": opened, "attempted": i, "failed": failed,
        "metrics": {"infer_mol_per_s": rows * len(state.done) / window_s},
        "record": {"window_s": window_s, "spans": dict(ctx.spans.seconds),
                   "live_row_steps": useful, "row_steps": rows * steps,
                   "model_flops": total, "peak_flops": PEAK_FLOPS[ctx.cfg["dtype"]],
                   "log": {"requests_seconds_steps_greedy": log}},
    }


def traced(ctx, state, record):
    """One sampled request timed, then the same request (the handle's
    generator seeded alike) under the profiler; both on the window's
    handle, whose decode graph they replay."""
    k1 = _roundtrip._k1()
    seed = ctx.seed + 1
    sync(ctx.device)
    state.model._generator.manual_seed(seed)
    start = now()
    state.call(ctx, state.model, 0)
    sync(ctx.device)
    wall = now() - start
    state.model._generator.manual_seed(seed)
    launches0 = k1.launches
    with profiled(ctx.device) as out:
        state.call(ctx, state.model, 0)
    record.update(traced_wall_s=wall,
                  traced_decode_steps=(k1.launches - launches0) / ctx.cfg["n_layer_xformer"])
    return out[0], wall


def release(ctx, state):
    state.model = state.rec = None
    torch.cuda.empty_cache() if torch.device(ctx.device).type == "cuda" else None


def sample(ctx, state, greedy: bool, rows: int):
    """(fixture indices, served rows) of the rows the check reads among the
    requests of one kind: the longest row and `rows` - 1 more drawn from
    the seed."""
    done = [(idx, s) for _, g, idx, s in state.done if g == greedy]
    if not done:
        return [], np.zeros((0, 0), np.int64)
    cand = [(j, r) for j, (_, s) in enumerate(done) for r in range(s.shape[0])]
    stop = state.tok.stop_token
    length = [flops.live_length(done[j][1][r: r + 1], stop)[0] for j, r in cand]
    rng = np.random.default_rng(ctx.seed + 2 + int(greedy))
    pick = {int(np.argmax(length))}
    pick |= set(rng.choice(len(cand), size=min(len(cand), rows) - 1, replace=False).tolist())
    pick = sorted(pick)[:rows]
    return ([int(done[cand[k][0]][0][cand[k][1]]) for k in pick],
            np.stack([done[cand[k][0]][1][cand[k][1]] for k in pick]))


def readings(ctx, state, q=None):
    """The numbers `correct` can compare (as roundtrip's), the reference
    embedding each row from its points; under `q` the control's."""
    t, cfg = ctx.traffic, ctx.cfg
    vocab = Vocabulary(cfg["vocab"])
    w = infer.reference_weights(cfg, ctx.seed, ctx.device)
    q = q or checks.EXACT
    out = {}

    def functions(idx):
        atoms = torch.as_tensor(state.atoms[idx], device=ctx.device)
        coords = torch.as_tensor(state.coords[idx], device=ctx.device)

        def embed(a, b, qq):
            h = egnn.encode_points(w["point_encoder"], atoms[a:b], coords[a:b], cfg["egnn_cutoff"],
                                   qq)
            return model.clip_projection(w["point_to_clip"], h, qq)

        def decode(h, toks, qq):
            return model.decode_logits(w, cfg, h, toks, vocab.unk, state.prefix_len, qq)

        return embed, decode

    idx, served = sample(ctx, state, True, t["check_rows"])
    if idx:
        gaps = teacher.decode_gaps(*functions(idx), vocab.stop, served, state.prefix_len,
                                   ctx.device, q)
        out.update(checks.gap_readings(gaps), greedy_rows=len(idx))
    idx, served = sample(ctx, state, False, t["check_rows_sampled"])
    if idx:
        g = teacher.sampled_gaps(*functions(idx), vocab.stop, served, state.prefix_len,
                                 ctx.device, t["k"], t["inv_temp"], q, ctx.seed + 4)
        out.update(checks.sampled_readings(g), sampled_rows=len(idx))
    return out
