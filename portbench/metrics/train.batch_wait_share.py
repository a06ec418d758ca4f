"""Share of a training step the trainer waits for its next batch from
the pipe (the program's `train.batch` span: the serial transform
included, and still measured once the transform leaves the loop): the
mean of the waits the profiled steps saw whole, over the window's mean
step without the profiler."""

from portbench import ranges


def read(r):
    trace, wall, steps = r.get("trace"), r.get("traced_wall_s"), r.get("traced_steps")
    if trace is None or not wall or not steps:
        return None
    ranges.log_idle_by_span(r)
    waits = ranges.fetches(trace)
    if not waits:
        return None
    return 100.0 * ranges.seconds(waits) / len(waits) / (wall / steps)
