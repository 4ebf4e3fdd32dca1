"""The stored index in bits a posting: 8 x (bytes of the shard-store the
session wrote, read from its files, + bytes of the learned model's tensors
that ``from_store`` takes) over the postings of the generated collection."""


def read(rec):
    fp = rec.get("footprint", {})
    if "store_bytes" not in fp:
        return None
    return 8 * (fp["store_bytes"] + fp["model_bytes"]) / fp["postings"]
