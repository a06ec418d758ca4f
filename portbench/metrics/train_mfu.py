"""The model FLOPs the window's training steps needed (costs/model.py:
live tokens, live atom pairs; forward times 3) over the window's time at
the card's peak for the configuration's type."""


def read(r):
    need, window, peak = r.get("model_flops"), r.get("window_s"), r.get("peak_flops")
    if not need or not window or not peak:
        return None
    return 100.0 * need / (window * peak)
