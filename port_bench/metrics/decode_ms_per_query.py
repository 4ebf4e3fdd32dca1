"""Host ms of the shards' tier-2 decodes (``decode.*`` spans, a decode span
inside another counted once, its kernels' wrappers included) per request."""
from port_bench.spans import span_ms


def read(rec):
    if "spans" not in rec or not rec["attempted"]:
        return None
    return span_ms(rec["spans"], lambda n: n.startswith("decode.")) / rec["attempted"]
