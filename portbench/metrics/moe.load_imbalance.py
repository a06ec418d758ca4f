"""How unevenly the router loads the experts held here: over the window's
calls, the mean over expert-layer passes (a decode step's layer, a chunk
of an encode's) of the held experts' highest token count over their mean
(1.0 = even), from the program's counters `moe.peak_over_mean_ppm` and
`moe.passes`."""


def read(r):
    counters = r.get("moe_window") or {}
    passes = counters.get("moe.passes")
    if not passes:
        return None
    return counters.get("moe.peak_over_mean_ppm", 0) / 1e6 / passes
