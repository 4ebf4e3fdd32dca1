"""Seconds of set-up spent forcing every shard's tier-2 store (the hybrid
codec choice and encoding of every posting list)."""


def read(rec):
    return rec.get("setup", {}).get("tier2_build")
