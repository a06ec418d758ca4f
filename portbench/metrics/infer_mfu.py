"""The model FLOPs the window's requests needed (costs/model.py: live
tokens, each row's own decode steps) over the window's time at the card's
peak for the configuration's type."""


def read(r):
    need, window, peak = r.get("model_flops"), r.get("window_s"), r.get("peak_flops")
    if not need or not window or not peak:
        return None
    return 100.0 * need / (window * peak)
