"""Share of the window the host spent in the program's tokenizer: the
benchmark's span around the tokenizer call of each request."""


def read(r):
    spent, window = r.get("spans", {}).get("tokenize"), r.get("window_s")
    if spent is None or not window:
        return None
    return 100.0 * spent / window
