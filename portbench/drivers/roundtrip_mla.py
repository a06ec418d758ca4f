"""Round trips of SMILES through COATI with DeepSeek-V2-Lite's block as its
trunk (configs/coati_dsv2lite.json): the traffic of the `roundtrip` driver
(requests of `rows` corpus SMILES, one per length stratum, tokenized by the
program, embedded and decoded back by `smiles_to_2d_batch`; every
`greedy_every`-th request greedy), on a model the program loads from a
seeded document through its own loader, as a COATI handle.

The window runs with the program's tracer started, for the expert layers'
counters (moe.*), which the program publishes once a call.

Correct: as `roundtrip`, against this configuration's plain reference
(reference/mla_moe.py, float32, the full form): the sampled greedy rows'
mean gap below the reference's best logit, the sampled top-k rows' |z|
and widest gap below its k-th best (teacher.py)."""

from __future__ import annotations

import numpy as np
import torch

from portbench import checks, harness, infer, teacher
from portbench.costs import PEAK_FLOPS
from portbench.costs import mla_moe as costs
from portbench.harness import now, profiled, sync
from portbench.reference import mla_moe as reference
from portbench.reference.tokenizer import Vocabulary

PREFIX = "[CLIP][UNK][SMILES]"

_roundtrip = harness.driver("roundtrip")


def _k6():
    from coati_tpu_torch.ops.kernels.mla_decode import mla_decode

    return mla_decode


def model_kwargs(cfg: dict) -> dict:
    """The COATI constructor's kwargs of the configuration."""
    ys = cfg["rope_scaling"]
    mla = {"kv_lora_rank": cfg["kv_lora_rank"], "qk_nope_head_dim": cfg["qk_nope_head_dim"],
           "qk_rope_head_dim": cfg["qk_rope_head_dim"], "v_head_dim": cfg["v_head_dim"],
           "n_dense": cfg["first_k_dense_replace"], "dense_width": cfg["intermediate_size"],
           "expert_width": cfg["moe_intermediate_size"], "n_routed": cfg["router_width"],
           "top_k": cfg["num_experts_per_tok"], "n_shared": cfg["n_shared_experts"],
           "first_expert": cfg["first_expert"], "n_held": cfg["n_routed_experts"],
           "rms_eps": cfg["rms_norm_eps"], "rope_theta": cfg["rope_theta"],
           "yarn_factor": ys["factor"], "yarn_original": ys["original_max_position_embeddings"],
           "yarn_beta_fast": ys["beta_fast"], "yarn_beta_slow": ys["beta_slow"],
           "yarn_mscale": ys["mscale"], "yarn_mscale_all_dim": ys["mscale_all_dim"]}
    return {"n_layer_xformer": cfg["num_hidden_layers"], "n_hidden_xformer": cfg["hidden_size"],
            "n_head": cfg["num_attention_heads"], "n_seq": cfg["n_seq"], "n_tok": cfg["vocab_size"],
            "n_layer_e3gnn": cfg["n_layer_e3gnn"], "n_hidden_e3nn": cfg["n_hidden_e3nn"],
            "n_embd_common": cfg["n_embd_common"], "mla": mla}


def build_model(cfg: dict, seed: int, device):
    """(COATI handle in the configuration's precision, tokenizer): the
    weights drawn from `seed` (reference.seeded), handed to the program's
    loader as a document."""
    from coati_tpu_torch.models.api import COATI
    from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e

    doc = {"model": reference.seeded(cfg, seed, device), "model_kwargs": model_kwargs(cfg),
           "train_args": {"tokenizer_vocab": cfg["vocab"]}}
    loaded, tok = load_e3gnn_smiles_clip_e2e(doc, device=device)
    del doc
    return COATI(loaded.params, loaded.config.replace(dtype=cfg["dtype"]), seed=seed), tok


class State(_roundtrip.State):
    def __init__(self, ctx):
        t = ctx.traffic
        self.model, self.tok = build_model(ctx.cfg, ctx.seed, ctx.device)
        self.rec = infer.RecordingTokenizer(self.tok)
        self.pool = infer.RequestPool(infer.load_corpus(t["corpus"]), t["rows"], ctx.seed,
                                      ctx.cfg["n_seq"] - 2)
        self.prefix_len = len(self.tok.tokenize_text(PREFIX, pad=False))
        self.done = []


def setup(ctx):
    state = State(ctx)
    # one request of each kind (greedy, then sampled): the second use of the
    # shape captures the decode graph, in set-up
    for w in range(min(2, ctx.traffic["greedy_every"])):
        state.call(ctx, state.model, -1 - w)
    sync(ctx.device)
    return state


def request_flops(cfg: dict, rows: np.ndarray, served: np.ndarray, stop: int,
                  prefix_len: int) -> float:
    live = _roundtrip.flops.live_length(rows, stop)
    total = costs.full_flops(live, cfg)
    total += rows.shape[0] * (costs.head_flops(cfg) + 2.0 * cfg["hidden_size"] * cfg["vocab_size"])
    total += costs.full_flops(np.full(rows.shape[0], prefix_len), cfg)
    pos = np.concatenate(_roundtrip._live_positions(served, stop, prefix_len))
    return total + costs.decode_flops(pos, cfg)


def k6_needed_s(cfg: dict, served: np.ndarray, stop: int, prefix_len: int) -> float:
    ends = np.asarray([len(p) + prefix_len
                       for p in _roundtrip._live_positions(served, stop, prefix_len)])
    h, lat, rope = cfg["num_attention_heads"], cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    total = sum(costs.k6_s(int((ends > pos).sum()), pos, h, lat, rope)
                for pos in range(prefix_len, int(ends.max())))
    return cfg["num_hidden_layers"] * total


def _moe_counters() -> dict:
    from coati_tpu_torch.common import tracing

    return {k: v for k, v in tracing.snapshot()["counters"].items()
            if k.startswith(("moe.", "decode.graph"))}


def window(ctx, state):
    from coati_tpu_torch.common import tracing

    k6 = _k6()
    n_layer = ctx.cfg["num_hidden_layers"]
    launches0 = k6.launches
    tracing.reset()
    tracing.start()
    ctx.spans.on = True
    opened, i, failed, ends, log = now(), 0, 0, [], []
    while now() - opened < ctx.seconds or len({g for _, g, _, _ in state.done}) < 2:
        sent, before = now(), k6.launches
        try:
            rows, served = state.call(ctx, state.model, i, ctx.spans)
            state.done.append((i, state.greedy(ctx, i), rows, served))
        except RuntimeError:
            failed += 1
        ends.append(now())
        log.append([round(ends[-1] - sent, 5), (k6.launches - before) // n_layer,
                    int(state.greedy(ctx, i))])
        i += 1
    ctx.spans.on = False
    tracing.stop()
    counters = _moe_counters()
    window_s = ends[-1] - opened
    stop, p = state.tok.stop_token, state.prefix_len
    steps = (k6.launches - launches0) / n_layer
    useful = sum(sum(len(x) for x in _roundtrip._live_positions(s, stop, p))
                 for _, _, _, s in state.done)
    total = sum(request_flops(ctx.cfg, r, s, stop, p) for _, _, r, s in state.done)
    mols = ctx.traffic["rows"] * len(state.done)
    return {
        "opened": opened, "attempted": i, "failed": failed,
        "metrics": {"infer_mol_per_s": mols / window_s},
        "record": {"window_s": window_s, "spans": dict(ctx.spans.seconds),
                   "live_row_steps": useful, "row_steps": ctx.traffic["rows"] * steps,
                   "model_flops": total, "peak_flops": PEAK_FLOPS[ctx.cfg["dtype"]],
                   "moe_window": counters,
                   "log": {"requests_seconds_steps_greedy": log,
                           "graph_captures_in_window": counters.get("decode.graph_captures", 0),
                           "graph_steps_in_window": counters.get("decode.graph_steps", 0),
                           "decode_steps_in_window": steps}},
    }


def traced(ctx, state, record):
    """One sampled request timed, then the same request (the handle's
    generator seeded alike) under the profiler; both on the window's
    handle, whose decode graph they replay."""
    from coati_tpu_torch.common import tracing

    k6 = _k6()
    seed = ctx.seed + 1
    sync(ctx.device)
    state.model._generator.manual_seed(seed)
    start = now()
    state.call(ctx, state.model, 0)
    sync(ctx.device)
    wall = now() - start
    state.model._generator.manual_seed(seed)
    launches0 = k6.launches
    tracing.reset()
    tracing.start()
    with profiled(ctx.device) as out:
        _, served = state.call(ctx, state.model, 0)
    tracing.stop()
    counters = _moe_counters()
    trace = out[0]
    cfg = ctx.cfg
    d, w = cfg["hidden_size"], cfg["moe_intermediate_size"]
    record.update({
        "traced_wall_s": wall, "traced_decode_steps": (k6.launches - launches0) / cfg["num_hidden_layers"],
        "k6_needed_s": k6_needed_s(cfg, served, state.tok.stop_token, state.prefix_len),
        "experts_needed_s": costs.experts_s(counters.get("moe.pairs_here", 0),
                                            counters.get("moe.experts_active", 0), d, w),
        "traced_counters": counters,
    })
    record["log"].update(traced_captures=counters.get("decode.graph_captures", 0))
    return trace, wall


def release(ctx, state):
    state.model = state.rec = None
    torch.cuda.empty_cache() if torch.device(ctx.device).type == "cuda" else None


def readings(ctx, state, q=None):
    """The numbers `correct` can compare (as roundtrip's), against the plain
    reference of this configuration; under `q` the control's."""
    t, cfg = ctx.traffic, ctx.cfg
    vocab = Vocabulary(cfg["vocab"])
    w = reference.seeded(cfg, ctx.seed, ctx.device)
    q = q or checks.EXACT
    out = {}

    def functions(smiles):
        src = torch.as_tensor(vocab.smiles_rows(smiles, cfg["n_seq"]), dtype=torch.long)
        src = src[:, : int((src != vocab.pad).sum(1).max())].to(ctx.device)

        def embed(a, b, qq):
            return reference.embed(w, cfg, src[a:b], vocab.stop, qq)

        def decode(h, toks, qq):
            return reference.decode_logits(w, cfg, h, toks, vocab.unk, state.prefix_len, qq)

        return embed, decode

    smiles, served = _roundtrip.sample(ctx, state, True, t["check_rows"])
    if smiles:
        gaps = teacher.decode_gaps(*functions(smiles), vocab.stop, served, state.prefix_len,
                                   ctx.device, q)
        out.update(checks.gap_readings(gaps), greedy_rows=len(smiles))
    smiles, served = _roundtrip.sample(ctx, state, False, t["check_rows_sampled"])
    if smiles:
        g = teacher.sampled_gaps(*functions(smiles), vocab.stop, served, state.prefix_len,
                                 ctx.device, t["k"], t["inv_temp"], q, ctx.seed + 4)
        out.update(checks.sampled_readings(g), sampled_rows=len(smiles))
    return out
