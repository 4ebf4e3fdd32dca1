"""Queries of the batches whose result words were complete on the card
inside the window, over the window's seconds."""


def read(rec):
    if "completed" not in rec:
        return None
    return len(rec["completed"]) * rec["batch"] / rec["window_s"]
