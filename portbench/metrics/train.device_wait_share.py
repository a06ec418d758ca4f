"""Share of a training step the host waits for the card (the program's
`train.device_wait` span: the deferred read of the last step's metrics):
the mean of those waits in the profiled steps, over the window's mean
step without the profiler."""

from portbench import ranges


def read(r):
    trace, wall, steps = r.get("trace"), r.get("traced_wall_s"), r.get("traced_steps")
    if trace is None or not wall or not steps:
        return None
    ranges.log_idle_by_span(r)
    waits = ranges.ranges(trace, "train.device_wait")
    if not waits:
        return None
    return 100.0 * ranges.seconds(waits) / len(waits) / (wall / steps)
