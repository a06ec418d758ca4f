#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The cell is portbench/workloads/<cell>.json; it names its configuration
(portbench/configs/<config>.json) and its driver
(portbench/drivers/<driver>.py). The driver sets up the program under test
(coati_tpu_torch) and warms it up, runs the measured window, and hands back
what the window did; this file then checks the outputs against the plain
reference and prints, as the last line on standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (with --trace 0 the cell's
end-to-end metrics of BENCHMARK.json, with --trace 1 its per-layer ones,
each read by portbench/metrics/<metric>.py), `device`, with --trace 1
`breakdown`, and last `checks`, each number compared beside its limit. The
same numbers are the last lines on standard error. Without the cards, or
with the JAX package or JAX loaded once the window has closed, it prints no
result and exits non-zero.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every kernel cache at a fixed path inside the checkout (the program's own
# CUDA builds go to coati_tpu_torch/_build/, also inside it)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".portbench_cache" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness  # noqa: E402

BENCH = ROOT / "portbench"


class Context:
    """One run: the cell, its configuration and traffic, the seed, the
    window's length, whether it is traced, and where it runs."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, device,
                 overrides=None, config=None):
        """`overrides` and `config` replace entries of the cell's and its
        configuration's files (the tests' small sizes)."""
        self.name = workload
        self.workload = json.loads((BENCH / "workloads" / f"{workload}.json").read_text())
        self.workload.update(overrides or {})
        self.cfg = json.loads((BENCH / "configs" / f"{self.workload['config']}.json").read_text())
        self.cfg.update(config or {})
        self.traffic = self.workload["traffic"]
        self.chips = self.workload["chips"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.spans = harness.Spans()
        self.log = {}  # what the window did beyond its metrics, for standard error


def _applies(metric: dict, cell: str, reported) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def compare(ctx: Context, readings: dict) -> list:
    """[(name, value, limit)] of the readings the cell holds to a limit;
    the others go to the log."""
    limits = ctx.workload["limits"]
    ctx.log["readings"] = {k: v for k, v in readings.items() if k not in limits}
    return [(k, float(readings.get(k, float("inf"))), limit) for k, limit in limits.items()]


def run_cell(ctx: Context, started: float, bench: dict):
    """Set up, measure, check; returns the result line as a dict (the
    caller prints it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = harness.driver(ctx.workload["driver"])
    state = drv.setup(ctx)
    # no collector pauses inside the window: what set-up left is collected
    # and frozen at its opening, and the collector stays off until it closes
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        res = drv.window(ctx, state)
    finally:
        gc.enable()
    opened = res["opened"]
    on_card = ctx.device.type == "cuda"
    device = harness.device_info(ctx.device, ctx.chips) if on_card else \
        {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    record = res["record"]
    e2e = [m for m in bench["end_to_end"] if ctx.name in m.get("workloads", [ctx.name])]
    values = dict(res["metrics"], setup_s=opened - started)
    line = {"correct": False, "attempted": res["attempted"], "failed": res["failed"]}
    if ctx.trace:
        trace, wall = drv.traced(ctx, state, record)
        record["trace"] = trace
        device.update(busy_s=trace.busy_s, window_s=wall)
        reported = {m["name"] for m in e2e}
        metrics = {}
        for m in bench["per_layer"]:
            if _applies(m, ctx.name, reported):
                value = harness.metric_reader(m["name"])(record)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        line["breakdown"] = trace.breakdown()
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    drv.release(ctx, state)
    checked = harness.now()
    compared = compare(ctx, drv.readings(ctx, state))
    ctx.log["check_s"] = harness.now() - checked
    line.update(correct=all(limit is not None and v <= limit for _, v, limit in compared),
                metrics=metrics,
                device=device)
    line = {k: line[k] for k in ("correct", "attempted", "failed", "metrics", "device",
                                 "breakdown") if k in line}
    line["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in compared}
    ctx.log.update(record.get("log", {}))
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    ctx = Context(args.workload, args.seed, args.seconds, args.trace, "cpu")
    if not torch.cuda.is_available() or torch.cuda.device_count() < ctx.chips:
        print(f"portbench: {args.workload} needs {ctx.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    ctx.device = torch.device("cuda:0")
    torch.cuda.set_device(ctx.device)
    torch.set_num_threads(1)  # one process, one intra-op thread: the host is shared
    line = run_cell(ctx, STARTED, bench)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"portbench: {json.dumps(ctx.log)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
