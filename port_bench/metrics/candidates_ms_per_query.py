"""Host ms of the shards' ``shard.candidate_mask`` spans (Algorithm 3's
candidate step, its kernels' wrappers included) per request of the window."""
from port_bench.spans import span_ms


def read(rec):
    if "spans" not in rec or not rec["attempted"]:
        return None
    return span_ms(rec["spans"], lambda n: n == "shard.candidate_mask") / rec["attempted"]
