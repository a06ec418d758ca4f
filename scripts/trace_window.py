#!/usr/bin/env python3
"""One cell of the port's benchmark with the port's tracer started over its
measured window.

    python3 scripts/trace_window.py --workload <cell> --seed <n> --seconds <s> --tracer <0|1>

from the root of a checkout, on a machine with the card. The cell runs as
`portbench/run.py --trace 0` runs it (the same set-up, window and checks).
With `--tracer 1` the tracer of `coati_tpu_torch/common/tracing.py` is
started when the driver's window begins and stopped when it returns, so the
end-to-end metrics are measured with the program's spans and counters on;
runs with `--tracer 0` and `--tracer 1` on the same seeds give the tracer's
cost. The last line on standard output is the benchmark's result line, and
with `--tracer 1` under `program` the window's shares read from the tracer
beside the same window's numbers read by the benchmark's own spans and
counters (the `twin_` keys):

  * round trips and embedding: `tokenize_share` (the `tokenize` spans over
    the window), `live_row_share` (`decode.live_row_steps` over
    `decode.row_steps`), `graph_share` (decode steps replayed from a
    captured CUDA graph, `decode.graph_steps`, over the `decode.step`
    spans; `graph_captures` beside it), `stop_wait_share`
    (`decode.stop_read` over `decode`);
  * training: `xform_share`, `batch_wait_share`, `device_wait_share`
    (the `train.xform`, `train.batch`, `train.device_wait` spans, each cut
    to the window, over the window).

A stopgap measurement tool: it wraps the drivers of `portbench/` and reads
keys private to them (`opened`, `spans`, `live_row_steps`). Delete it when
the drivers start the tracer over their window themselves.
"""

import argparse
import contextlib
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import run as bench  # noqa: E402  (first: set-up is timed from its import)
from portbench import harness  # noqa: E402

from coati_tpu_torch.common import tracing  # noqa: E402


def _share(part, whole):
    return 100.0 * part / whole if whole else None


def window_readings(res: dict, snap: dict, to_epoch: float) -> dict:
    """The tracer's shares of the window (and the benchmark's twins) from
    the driver's result and the tracer's snapshot; `to_epoch` turns the
    host clock of the result into the records' Unix seconds."""
    record = res["record"]
    window_s = record["window_s"]
    spans, counters = snap["spans"], snap["counters"]
    seconds = {k: v["seconds"] for k, v in spans.items()}
    out = {"spans": spans, "counters": counters, "dropped": snap["dropped"]}
    if "train.step" in spans:
        opened = res["opened"] + to_epoch
        closed = opened + window_s
        cut = {}
        for r in snap["records"]:
            s, e = r["start_ns"] / 1e9, r["end_ns"] / 1e9
            cut[r["name"]] = cut.get(r["name"], 0.0) + max(0.0, min(e, closed) - max(s, opened))
        for key, name in (("xform_share", "train.xform"), ("batch_wait_share", "train.batch"),
                          ("device_wait_share", "train.device_wait")):
            out[key] = _share(cut.get(name, 0.0), window_s)
        out["twin_xform_share"] = _share(record["spans"].get("xform", 0.0), window_s)
        return out
    out["tokenize_share"] = _share(seconds.get("tokenize", 0.0), window_s)
    out["twin_tokenize_share"] = _share(record["spans"].get("tokenize", 0.0), window_s)
    if "decode" in seconds:
        out["live_row_share"] = _share(counters.get("decode.live_row_steps", 0),
                                       counters.get("decode.row_steps", 0))
        out["twin_live_row_share"] = _share(record["live_row_steps"], record["row_steps"])
        out["graph_share"] = _share(counters.get("decode.graph_steps", 0),
                                    spans.get("decode.step", {}).get("count", 0))
        out["graph_captures"] = counters.get("decode.graph_captures", 0)
        out["stop_wait_share"] = _share(seconds.get("decode.stop_read", 0.0), seconds["decode"])
    return out


class TracedDriver:
    """A driver whose window runs with the tracer started."""

    def __init__(self, real):
        self._real = real
        self.window_numbers = None

    def __getattr__(self, name):
        return getattr(self._real, name)

    def window(self, ctx, state):
        to_epoch = time.time() - harness.now()
        tracing.reset()
        tracing.start()
        try:
            res = self._real.window(ctx, state)
        finally:
            tracing.stop()
        self.window_numbers = window_readings(res, tracing.snapshot(), to_epoch)
        return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    args = parser.parse_args(argv)
    drivers = []
    if args.tracer:
        load = harness.driver

        def traced(name):
            drivers.append(TracedDriver(load(name)))
            return drivers[-1]

        bench.harness.driver = traced
    rest = ["--workload", args.workload, "--seed", str(args.seed), "--seconds",
            str(args.seconds), "--trace", "0"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(rest)
    printed = out.getvalue().splitlines()
    if rc == 0 and drivers:
        line = json.loads(printed[-1])
        line["program"] = drivers[-1].window_numbers
        printed[-1] = json.dumps(line)
    print("\n".join(printed), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
