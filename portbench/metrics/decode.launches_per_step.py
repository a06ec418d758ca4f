"""Kernel launches of one decode step: the card's kernels that start
inside the program's `decode.step` spans of the profiled request, over
the number of those spans. Each step ends in the host's read of
`stopped.all()`, which waits for every kernel the step launched, so a
step's kernels run inside its span and no other's."""

from portbench import ranges


def read(r):
    trace = r.get("trace")
    if trace is None:
        return None
    ranges.log_idle_by_span(r)
    steps = ranges.ranges(trace, "decode.step")
    if not steps:
        return None
    r["log"].update(decode_step_spans=len(steps), decode_steps_by_k1=r.get("traced_decode_steps"))
    return ranges.kernels_inside(trace, steps) / len(steps)
