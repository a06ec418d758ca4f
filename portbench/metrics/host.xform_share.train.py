"""Share of the window the host spent in the trainer's batch transform
(clip_ar_xform), spanned around each call the trainer's pipe makes."""


def read(r):
    spent, window = r.get("spans", {}).get("xform"), r.get("window_s")
    if spent is None or not window:
        return None
    return 100.0 * spent / window
