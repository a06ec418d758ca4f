#!/usr/bin/env python3
"""Readings the limits of `correct` are set from, for a round-trip cell whose
driver calibrate.py does not know (roundtrip_mla, roundtrip_points), on the
card.

    python3 portbench/calibrate_round_trips.py --workload <cell> --seeds 11,12,13 [--control-seeds 3]

As calibrate.py does for `roundtrip`: for each seed, in one process, the
cell's set-up and a short window at the cell's own sizes (one request of
each kind the check reads), then the numbers compared, read three ways:
the program's (the lower readings), the control's (the reference one
precision below the configuration's; the upper readings) and each planted
sampler fault's (faults.SAMPLER, each in a window of its own). One JSON
line a seed on standard output and in chiprun_out/calibrate_<cell>.jsonl.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import checks, faults, harness  # noqa: E402
from portbench.run import Context  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", type=int, default=3,
                        help="the first this many seeds also read the control and the faults")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_round_trips: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    log = out_dir / f"calibrate_{args.workload}.jsonl"
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        ctx = Context(args.workload, seed, 0.001, False, "cuda:0")
        ctx.traffic.update(greedy_every=2)
        drv = harness.driver(ctx.workload["driver"])
        start = time.perf_counter()
        state = drv.setup(ctx)
        drv.window(ctx, state)
        planted = {}
        if n < args.control_seeds:
            sound = state.done
            for name, fault in faults.SAMPLER.items():
                state.done = []
                with fault():
                    drv.window(ctx, state)
                planted[name] = state.done
            state.done = sound
        drv.release(ctx, state)
        row = {"cell": args.workload, "seed": seed, "program": drv.readings(ctx, state)}
        if n < args.control_seeds:
            row["control"] = drv.readings(ctx, state, checks.control_precision(ctx.cfg))
            for name, done in planted.items():
                state.done = done
                row[name] = drv.readings(ctx, state)
        row["seconds"] = time.perf_counter() - start
        row["kind"] = torch.cuda.get_device_name(0)
        line = json.dumps(row)
        print(line, flush=True)
        with open(log, "a") as f:
            f.write(line + "\n")
        del state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
