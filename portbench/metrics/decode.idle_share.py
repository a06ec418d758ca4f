"""Share of the decode loop's time the card ran nothing: the seconds of
the program's `decode` spans in the profiled request in which no device
operation ran, over those spans' seconds (both from the one profile)."""

from portbench import ranges


def read(r):
    trace = r.get("trace")
    if trace is None:
        return None
    ranges.log_idle_by_span(r)
    decode = ranges.ranges(trace, "decode")
    if not decode:
        return None
    return 100.0 * ranges.idle_inside(trace, decode) / ranges.seconds(decode)
