"""The 95th percentile (nearest rank) of every Boolean request's latency
answered in the window, submit to answer on the client's clock."""
from port_bench.stats import percentile


def read(rec):
    if "answered_in_window" not in rec or not rec["latency_s"]:
        return None
    return percentile(rec["latency_s"], 95) * 1e3
