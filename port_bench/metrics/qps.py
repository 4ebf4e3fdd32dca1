"""Exact queries answered inside the window over the window's seconds."""


def read(rec):
    if "answered_in_window" not in rec:
        return None
    return rec["answered_in_window"] / rec["window_s"]
