"""Useful over attempted decode work in the window: row-steps up to each
row's [STOP], read from the served tokens, over rows times the decode
steps the calls ran (K1 launches over the layers)."""


def read(r):
    useful, attempted = r.get("live_row_steps"), r.get("row_steps")
    if not useful or not attempted:
        return None
    return 100.0 * useful / attempted
