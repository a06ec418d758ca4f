"""Share of a training step the trainer's batch transform takes (the
program's `train.xform` span inside `xform_routine`): the mean of the
transforms inside the batch waits the profiled steps saw whole, over the
window's mean step without the profiler."""

from portbench import ranges


def read(r):
    trace, wall, steps = r.get("trace"), r.get("traced_wall_s"), r.get("traced_steps")
    if trace is None or not wall or not steps:
        return None
    ranges.log_idle_by_span(r)
    waits = ranges.fetches(trace)
    xform = ranges.within(ranges.ranges(trace, "train.xform"), waits)
    if not xform:
        return None
    return 100.0 * ranges.seconds(xform) / len(waits) / (wall / steps)
