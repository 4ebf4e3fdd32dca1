"""``BooleanEngine.memory_report()``'s bits (model, tier-1, block bitmaps,
backup keys, tier-2), summed, over the generated postings."""


def read(rec):
    fp = rec.get("footprint", {})
    if "eq2_bits" not in fp:
        return None
    return fp["eq2_bits"] / fp["postings"]
