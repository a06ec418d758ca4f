"""Kernel launches in the traced training steps, per step."""


def read(r):
    trace, steps = r.get("trace"), r.get("traced_steps")
    if trace is None or not steps:
        return None
    return trace.launches / steps
