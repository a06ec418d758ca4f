"""Share of training time the card ran nothing: one minus the union of
its operations' intervals in the profiled steps over as many of the
window's steps (their mean time, without the profiler)."""


def read(r):
    trace, wall = r.get("trace"), r.get("traced_wall_s")
    if trace is None or not wall:
        return None
    return 100.0 * (1.0 - trace.busy_s / wall)
