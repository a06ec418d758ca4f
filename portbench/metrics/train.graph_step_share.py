"""Share of the profiled training steps the program replayed from a CUDA
graph: the program's `train.step` ranges that hold a `train.graph_replay`
range, over all of them. A program without the training graph (no module
`coati_tpu_torch.training.step_graph`) has no such span, and this returns
None there."""

import importlib.util

from portbench import ranges


def read(r):
    trace = r.get("trace")
    if trace is None or importlib.util.find_spec("coati_tpu_torch.training.step_graph") is None:
        return None
    steps = ranges.ranges(trace, "train.step")
    if not steps:
        return None
    replays = ranges.ranges(trace, "train.graph_replay")
    replayed = sum(any(s <= rs and re <= e for rs, re in replays) for s, e in steps)
    return 100.0 * replayed / len(steps)
