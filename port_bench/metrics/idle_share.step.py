"""The share of the traced window in which no kernel, copy or set ran on
the card (torch.profiler)."""


def read(rec):
    if "kernel_s" not in rec:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["traced_window_s"])
