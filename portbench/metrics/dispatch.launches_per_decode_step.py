"""Kernel launches in a traced round trip (encode, prefill and decode) over
its decode steps (K1 launches over the layers)."""


def read(r):
    trace, steps = r.get("trace"), r.get("traced_decode_steps")
    if trace is None or not steps:
        return None
    return trace.launches / steps
