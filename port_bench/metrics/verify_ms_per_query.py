"""Host ms of the shards' ``shard.verify`` rounds (guided probes and the
tier-2 decodes they read included) per request of the window."""
from port_bench.spans import span_ms


def read(rec):
    if "spans" not in rec or not rec["attempted"]:
        return None
    return span_ms(rec["spans"], lambda n: n == "shard.verify") / rec["attempted"]
