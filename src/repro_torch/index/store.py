"""Persistent index format: InvertedIndex + HybridPostings on disk, mmap-lazy.

The port's copy of the reference's shard-store (same layout, same bytes):
a directory written by either package loads in the other.  A serving
process that starts from it re-runs no codec selection and no PLM/RMI fit:
the CSR inverted index and every term's tag-prefixed hybrid stream (codec
tag, ε, segment models, bit-packed corrections) are flat binary arenas,
loaded back with ``np.memmap`` so an engine starts in O(open) time and only
the stream bytes a query reads are paged in.

Single-index layout (``save_index`` / ``load_index``)::

  <dir>/meta.json           magic, STORE_VERSION, n_docs/n_terms/universe,
                            per-array dtype+shape manifest, crc32 checksums
  <dir>/term_offsets.bin    int64  (n_terms+1,)   CSR offsets into doc_ids
  <dir>/doc_ids.bin         int32  (n_postings,)  sorted per term
  <dir>/tfs.bin             int32  (n_postings,)  term frequencies (may be empty)
  <dir>/lens.bin            int64  (n_terms,)     posting-list lengths
  <dir>/tags.bin            uint8  (n_terms,)     codec tag per term
  <dir>/bits.bin            int64  (n_terms,)     measured size incl. TAG_BITS
  <dir>/stream_offsets.bin  int64  (n_terms+1,)   word offsets into streams
  <dir>/streams.bin         uint32 (total_words,) tag-prefixed hybrid streams
  <dir>/payload_offsets.bin int64  (n_terms+1,)   word offsets into payloads
  <dir>/payloads.bin        uint32 (payload_words,) packed quantized impacts
  <dir>/ub_offsets.bin      int64  (n_terms+1,)   offsets into seg_ubs
  <dir>/seg_ubs.bin         uint32 (n_segments,)  per-segment score bounds

Layout v2 added the ranked-tier arrays (tfs, payloads, segment score
bounds); a v1 directory still loads — its payload arrays are simply absent
and the store serves Boolean-only.  Loading a layout *newer* than this
reader raises ``UnsupportedVersionError`` before any array is parsed.

Doc-partitioned layout (``save_sharded`` / ``load_sharded``): a top-level
``shards.json`` records the version, global doc count and every shard's
``[lo, hi)`` doc-id range; ``shard-NNNN/`` subdirectories each hold one
single-index layout over *local* doc ids (``global = local + lo``).

Round-trips are bit-exact per codec: streams are written verbatim, so a
reloaded store decodes the identical word sequences the tier-2 build measured.

``StreamArena`` here is the host-side, lazy per-term view of a flat
(possibly memmapped) word array, the reference's class of that name; the
device arena of learned streams that ``guided_search`` reads is
``postings.search.StreamArena``.  Import them by module, not by name.
"""
from __future__ import annotations

import json
import os
import zlib

import numpy as np

from repro_torch.index.build import InvertedIndex
from repro_torch.postings.hybrid import HybridPostings

STORE_VERSION = 2  # v2: ranked payload streams + segment score bounds
MAGIC = "repro-index"
META = "meta.json"
SHARDS_META = "shards.json"

_ARRAYS = (
    # (name, attr owner, dtype)
    ("term_offsets", "inv", np.int64),
    ("doc_ids", "inv", np.int32),
    ("lens", "store", np.int64),
    ("tags", "store", np.uint8),
    ("bits", "store", np.int64),
    ("stream_offsets", "store", np.int64),
    ("streams", "store", np.uint32),
)

# layout-v2 additions; absent from v1 metas, loaded only when present
_ARRAYS_V2 = (
    ("tfs", "inv", np.int32),
    ("payload_offsets", "store", np.int64),
    ("payloads", "store", np.uint32),
    ("ub_offsets", "store", np.int64),
    ("seg_ubs", "store", np.uint32),
)


class UnsupportedVersionError(ValueError):
    """The on-disk layout was written by a newer repro than this reader."""


class StreamArena:
    """Per-term uint32 stream views into one flat (possibly memmapped) arena.

    Quacks like the ``list[np.ndarray]`` HybridPostings carries when built in
    memory, but holds a single backing buffer: ``arena[t]`` is a zero-copy
    slice, so loading an index touches no stream bytes until a term is probed.
    """

    def __init__(self, words: np.ndarray, offsets: np.ndarray):
        self._words = words
        self._offsets = offsets

    def __len__(self) -> int:
        return len(self._offsets) - 1

    def __getitem__(self, t: int) -> np.ndarray:
        return self._words[int(self._offsets[t]) : int(self._offsets[t + 1])]

    def __iter__(self):
        return (self[t] for t in range(len(self)))


def _flatten_streams(streams) -> tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(streams) + 1, np.int64)
    np.cumsum([int(s.size) for s in streams], out=offsets[1:])
    if int(offsets[-1]) == 0:
        return np.zeros(0, np.uint32), offsets
    return np.concatenate([np.asarray(s, np.uint32) for s in streams]), offsets


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def save_index(path: str, inv: InvertedIndex, store: HybridPostings) -> None:
    """Write one (inverted index, hybrid store) pair to a versioned layout."""
    if store.n_terms != inv.n_terms:
        raise ValueError(f"store has {store.n_terms} terms, index {inv.n_terms}")
    os.makedirs(path, exist_ok=True)
    streams, stream_offsets = _flatten_streams(store.streams)
    arrays = {
        "term_offsets": np.asarray(inv.term_offsets, np.int64),
        "doc_ids": np.asarray(inv.doc_ids, np.int32),
        "tfs": (np.zeros(0, np.int32) if inv.tfs is None
                else np.asarray(inv.tfs, np.int32)),
        "lens": np.asarray(store.lens, np.int64),
        "tags": np.asarray(store.tags, np.uint8),
        "bits": np.asarray(store.bits, np.int64),
        "stream_offsets": stream_offsets,
        "streams": streams,
    }
    if store.has_payloads:
        payloads, payload_offsets = _flatten_streams(store.payload_streams)
        arrays["payload_offsets"] = payload_offsets
        arrays["payloads"] = payloads
        arrays["ub_offsets"] = np.asarray(store.ub_offsets, np.int64)
        arrays["seg_ubs"] = np.asarray(store.seg_ubs, np.uint32)
    else:
        zero_off = np.zeros(store.n_terms + 1, np.int64)
        arrays["payload_offsets"] = zero_off
        arrays["payloads"] = np.zeros(0, np.uint32)
        arrays["ub_offsets"] = zero_off
        arrays["seg_ubs"] = np.zeros(0, np.uint32)
    manifest = list(_ARRAYS) + list(_ARRAYS_V2)
    meta = {
        "magic": MAGIC,
        "version": STORE_VERSION,
        "n_docs": int(inv.n_docs),
        "n_terms": int(inv.n_terms),
        "universe": int(store.universe),
        "n_postings": int(inv.n_postings),
        "payload_bits": int(store.payload_bits),
        "payload_scale": float(store.payload_scale),
        "arrays": {
            name: {"dtype": np.dtype(dt).name, "shape": list(arrays[name].shape),
                   "crc32": _crc(arrays[name])}
            for name, _, dt in manifest
        },
    }
    for name, _, dt in manifest:
        arrays[name].astype(dt, copy=False).tofile(os.path.join(path, f"{name}.bin"))
    # meta last: a directory without meta.json is an aborted write, not an index
    with open(os.path.join(path, META), "w") as f:
        json.dump(meta, f, indent=1)


def _read_meta(path: str) -> dict:
    meta_path = os.path.join(path, META)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no index at {path} ({META} missing)")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("magic") != MAGIC:
        raise ValueError(f"{path}: not a {MAGIC} store")
    _check_version(meta, path)
    return meta


def _check_version(meta: dict, path: str) -> None:
    """Reject layouts this reader cannot parse, clearly.

    Newer layouts raise UnsupportedVersionError up front (rather than a
    crc/parse crash halfway into an array whose meaning changed); older
    versions back to 1 load fine — their additions are simply absent.
    """
    version = meta.get("version")
    if not isinstance(version, int) or version < 1:
        raise ValueError(f"{path}: bad store version {version!r}")
    if version > STORE_VERSION:
        raise UnsupportedVersionError(
            f"{path}: layout version {version} was written by a newer repro "
            f"(this reader supports <= {STORE_VERSION}); upgrade the reader "
            f"or re-save the index with it"
        )


def load_index(
    path: str, *, mmap: bool = True, verify: bool = False
) -> tuple[InvertedIndex, HybridPostings]:
    """Open a saved index.  mmap=True (default) pages bytes in lazily;
    verify=True additionally checks every array's crc32 (reads everything)."""
    meta = _read_meta(path)
    arrays: dict[str, np.ndarray] = {}
    manifest = [
        (name, owner, dt)
        for name, owner, dt in list(_ARRAYS) + list(_ARRAYS_V2)
        if name in meta["arrays"]  # v1 metas lack the ranked-tier arrays
    ]
    for name, _, dt in manifest:
        spec = meta["arrays"][name]
        fp = os.path.join(path, f"{name}.bin")
        n = int(np.prod(spec["shape"])) if spec["shape"] else 0
        if n == 0:
            arrays[name] = np.zeros(spec["shape"], dtype=dt)
        elif mmap:
            arrays[name] = np.memmap(fp, dtype=dt, mode="r", shape=tuple(spec["shape"]))
        else:
            arrays[name] = np.fromfile(fp, dtype=dt).reshape(spec["shape"])
        if verify and _crc(arrays[name]) != spec["crc32"]:
            raise ValueError(f"{path}/{name}.bin: crc32 mismatch (corrupt store)")
    tfs = arrays.get("tfs")
    inv = InvertedIndex(
        n_docs=meta["n_docs"],
        n_terms=meta["n_terms"],
        term_offsets=arrays["term_offsets"],
        doc_ids=arrays["doc_ids"],
        tfs=tfs if tfs is not None and tfs.size else None,
    )
    store = HybridPostings(
        universe=meta["universe"],
        lens=arrays["lens"],
        tags=arrays["tags"],
        bits=arrays["bits"],
        streams=StreamArena(arrays["streams"], arrays["stream_offsets"]),
    )
    if int(meta.get("payload_bits", 0)) > 0 and "payloads" in arrays:
        store.set_payloads(
            StreamArena(arrays["payloads"], arrays["payload_offsets"]),
            bits=int(meta["payload_bits"]),
            scale=float(meta.get("payload_scale", 0.0)),
            ub_offsets=arrays["ub_offsets"],
            seg_ubs=arrays["seg_ubs"],
        )
    return inv, store


# -------------------------------------------------------------- sharded form
def _check_ranges(ranges, n_docs: int) -> None:
    """Ranges must tile [0, n_docs) contiguously with 32-aligned interior
    boundaries — BooleanEngine._merge word-copies each shard's packed bitmap
    at lo//32, so a misaligned or overlapping range would silently remap doc
    ids instead of failing."""
    prev = 0
    for i, (lo, hi) in enumerate(ranges):
        if lo != prev or hi < lo:
            raise ValueError(f"shard {i}: range [{lo}, {hi}) breaks contiguity at {prev}")
        if hi != n_docs and hi % 32 != 0:
            raise ValueError(f"shard {i}: boundary {hi} not 32-aligned")
        prev = hi
    if prev != n_docs:
        raise ValueError(f"shard ranges cover [0, {prev}), index has {n_docs} docs")


def save_sharded(
    path: str,
    n_docs: int,
    shards: list[tuple[tuple[int, int], InvertedIndex | None, HybridPostings | None]],
) -> None:
    """Write a doc-partitioned index: shards.json + one subdir per shard.

    ``shards`` lists ((lo, hi), local_inv, local_store) tiling [0, n_docs)
    contiguously with 32-aligned interior boundaries (checked — the bitmap
    merge depends on it); empty ranges (lo == hi) are recorded in the
    manifest but get no subdir and may carry None payloads.
    """
    _check_ranges([r for r, _, _ in shards], n_docs)
    os.makedirs(path, exist_ok=True)
    ranges = []
    for i, ((lo, hi), inv, store) in enumerate(shards):
        ranges.append([int(lo), int(hi)])
        if hi > lo:
            save_index(os.path.join(path, f"shard-{i:04d}"), inv, store)
    with open(os.path.join(path, SHARDS_META), "w") as f:
        json.dump({"magic": MAGIC, "version": STORE_VERSION,
                   "n_docs": int(n_docs), "ranges": ranges}, f, indent=1)


def load_sharded(
    path: str, *, mmap: bool = True, verify: bool = False
) -> tuple[int, list[tuple[tuple[int, int], InvertedIndex | None, HybridPostings | None]]]:
    """-> (n_docs, [((lo, hi), inv, store)]); empty ranges load as (None, None)."""
    meta_path = os.path.join(path, SHARDS_META)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no sharded index at {path} ({SHARDS_META} missing)")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("magic") != MAGIC:
        raise ValueError(f"{path}: not a {MAGIC} sharded store")
    _check_version(meta, path)
    _check_ranges(meta["ranges"], int(meta["n_docs"]))
    out = []
    for i, (lo, hi) in enumerate(meta["ranges"]):
        if hi > lo:
            inv, store = load_index(
                os.path.join(path, f"shard-{i:04d}"), mmap=mmap, verify=verify
            )
            if inv.n_docs != hi - lo:
                raise ValueError(f"{path}/shard-{i:04d}: {inv.n_docs} docs != range {hi - lo}")
        else:
            inv = store = None
        out.append(((int(lo), int(hi)), inv, store))
    return int(meta["n_docs"]), out
