"""Share of the decode loop's host time spent in its reads of
`stopped.all()` (the early exit's sync): the program's `decode.stop_read`
spans over its `decode` spans, in the profiled request."""

from portbench import ranges


def read(r):
    trace = r.get("trace")
    if trace is None:
        return None
    ranges.log_idle_by_span(r)
    decode = ranges.ranges(trace, "decode")
    if not decode:
        return None
    return 100.0 * ranges.seconds(ranges.ranges(trace, "decode.stop_read")) / ranges.seconds(decode)
