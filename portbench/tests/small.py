"""Small sizes of the benchmark's cells for the CPU: the same drivers,
references and checks, at widths a test run holds."""

import json
import time
from pathlib import Path

from portbench.run import BENCH, Context, run_cell

ROOT = Path(__file__).resolve().parents[2]
TINY = {"n_layer_xformer": 4, "n_hidden_xformer": 64, "n_head": 4, "n_seq": 64,
        "n_layer_e3gnn": 2, "n_hidden_e3nn": 32, "n_embd_common": 64, "embed_dim": 64,
        "weights": {"seeded": "test"}}
TRAIN_WIDTHS = {k: TINY[k] for k in ("n_layer_xformer", "n_hidden_xformer", "n_head",
                                     "n_layer_e3gnn", "n_hidden_e3nn", "n_embd_common")}


def context(cell: str, seed: int = 2**31 + 17, seconds: float = 1.0, trace: bool = False,
            limits=None, full: bool = False) -> Context:
    """The cell with small traffic; at small widths too unless `full` (the
    cell's own configuration, as its file states it)."""
    wl = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    traffic = dict(wl["traffic"])
    if wl["driver"] == "train":
        traffic.update(batch_size=8, warmup_steps=4, traced_steps=2,
                       overrides=dict(traffic["overrides"], **TRAIN_WIDTHS, batch_size=8))
    else:
        traffic.update(rows=8, check_rows=8, check_rows_sampled=8, greedy_every=2,
                       warmup_requests=1, traced_requests=1)
    overrides = {"traffic": traffic}
    if limits is not None:
        overrides["limits"] = limits
    config = TINY if wl["driver"] != "train" else {k: v for k, v in TINY.items() if k != "n_seq"}
    if full:
        config = {}
    return Context(cell, seed, seconds, trace, "cpu", overrides=overrides, config=config)


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def run(ctx: Context) -> dict:
    return run_cell(ctx, time.perf_counter(), bench())
