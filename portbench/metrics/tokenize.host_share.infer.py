"""Share of the traced requests' time the host spent in the program's
tokenizer: the `tokenize` spans of the program (one a string, in the
requests' tokenization and in the API's prefix) in the profiled requests,
over the same requests' time without the profiler."""

from portbench import ranges


def read(r):
    trace, wall = r.get("trace"), r.get("traced_wall_s")
    if trace is None or not wall:
        return None
    ranges.log_idle_by_span(r)
    spans = ranges.ranges(trace, "tokenize")
    return 100.0 * ranges.seconds(spans) / wall if spans else None
