"""The 95th percentile (nearest rank) of every batch's latency in the
window: hand-over to the step until its completion event."""
from port_bench.stats import percentile


def read(rec):
    if "completed" not in rec or not rec["latency_s"]:
        return None
    return percentile(rec["latency_s"], 95) * 1e3
