"""Tile autotuner for the dense ranked pass.

The dense path (kernels.fused_query.dense) pads every batch to a (rows,
terms) bucket: the row quantum and the term quantum trade padding waste
(large quanta score pad rows and read pad slots) against shape churn (small
quanta give each batch size its own shape).  The right point depends on
the device, so it is searched, not hard-coded: ``autotune_dense`` times a
mixed-batch-size synthetic workload under each (row_quantum, term_quantum)
candidate on the given device, picks the fastest, applies it
(``dense.set_tile_params``) and saves the choice to a JSON cache keyed by
device.

The cache (``artifacts/autotune_cache_torch.json``, the port's own file, so
neither package reads the other's tuning) is a plain
``{device_key: {"dense": {...}, "timings_us": {...}}}`` map:
``apply_cache()`` restores a tuned configuration at startup without
searching again, and a tuning taken on one device never applies to
another.  Nothing applies the cache by default.

Run on the card (``python -m repro_torch.kernels.autotune``, or
``--device cpu``) to tune and write the cache.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

DEFAULT_CACHE = os.path.join("artifacts", "autotune_cache_torch.json")
ROW_QUANTA = (4, 8, 16)
TERM_QUANTA = (2, 4, 8)


def device_key(device: torch.device | str = "cuda") -> str:
    """Stable identity of the device the timings were taken on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


def _bucket(n: int, quantum: int) -> int:
    b = quantum
    while b < n:
        b *= 2
    return b


def _synthetic_arena(n_docs: int, n_terms: int, avg_len: int, seed: int,
                     device: torch.device | str):
    """A DeviceArena over synthetic postings on ``device``: no index needed.
    The same seed gives the reference's table, byte for byte."""
    from repro_torch.kernels.arena import DeviceArena

    rng = np.random.default_rng(seed)
    table = np.zeros((n_terms + 1, n_docs), np.uint8)
    lens = np.zeros(n_terms, np.int64)
    for t in range(n_terms):
        n = int(min(n_docs, 1 + rng.poisson(avg_len)))
        ids = rng.choice(n_docs, size=n, replace=False)
        table[t, ids] = rng.integers(1, 32, size=n)
        lens[t] = n
    return DeviceArena(n_docs=n_docs, n_terms=n_terms,
                       table=torch.from_numpy(table).to(device), host_lens=lens)


def _workload(n_terms: int, batch_sizes, terms_per_query: int, seed: int):
    """Mixed-size batches of random term lists, the shapes coalesced traffic
    produces, so the tuner pays for shape churn exactly when serving would."""
    rng = np.random.default_rng(seed)
    batches = []
    for q in batch_sizes:
        batch = []
        for _ in range(q):
            w = int(rng.integers(2, terms_per_query + 1))
            batch.append(sorted(rng.choice(n_terms, size=w, replace=False)))
        batches.append(batch)
    return batches


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_config(arena, batches, k: int, row_q: int, term_q: int, reps: int) -> float:
    """Best seconds of ``reps`` runs of the workload under one tile pair,
    each run ending when the card has finished (``torch.cuda.synchronize``)."""
    from repro_torch.kernels.fused_query import dense

    dense.set_tile_params(row_q, term_q)
    dev = arena.table.device

    def run_once() -> None:
        for batch in batches:
            Qb = _bucket(len(batch), row_q)
            T = _bucket(max(len(ts) for ts in batch), term_q)
            qt = np.full((Qb, T), -1, np.int32)
            for i, ts in enumerate(batch):
                qt[i, : len(ts)] = ts
            floors = np.zeros(Qb, np.int32)
            dense.dense_topk(arena, qt, floors, k=k)
        _sync(dev)

    run_once()  # the first call builds and loads the kernel: steady state is what's tuned
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        run_once()
        best = min(best, time.perf_counter() - t0)
    return float(best)


def autotune_dense(
    *,
    n_docs: int = 4096,
    n_terms: int = 512,
    avg_len: int = 48,
    batch_sizes=(1, 3, 5, 8, 13, 16),
    terms_per_query: int = 6,
    k: int = 10,
    reps: int = 3,
    seed: int = 7,
    device: torch.device | str = "cuda",
    cache_path: str | None = DEFAULT_CACHE,
) -> dict:
    """Search (row_quantum, term_quantum), apply the winner, save it.

    Returns ``{"device": key, "dense": best_params, "timings_us": {...}}``;
    the process-wide tile params are left set to the winner.
    """
    from repro_torch.kernels.fused_query import dense

    arena = _synthetic_arena(n_docs, n_terms, avg_len, seed, device)
    batches = _workload(n_terms, batch_sizes, terms_per_query, seed + 1)
    prev = dense.tile_params()
    timings: dict[str, float] = {}
    best_cfg, best_s = None, np.inf
    try:
        for row_q in ROW_QUANTA:
            for term_q in TERM_QUANTA:
                s = _time_config(arena, batches, k, row_q, term_q, reps)
                timings[f"{row_q}x{term_q}"] = 1e6 * s
                if s < best_s:
                    best_cfg, best_s = (row_q, term_q), s
    finally:
        # the winner sticks; anything else (an exception midway included)
        # restores the tunables the process started with
        if best_cfg is not None:
            dense.set_tile_params(*best_cfg)
        else:
            dense.set_tile_params(prev["row_quantum"], prev["term_quantum"])
    report = {
        "device": device_key(arena.table.device),
        "dense": {"row_quantum": best_cfg[0], "term_quantum": best_cfg[1]},
        "best_us": 1e6 * best_s,
        "timings_us": timings,
        "workload": {
            "n_docs": n_docs,
            "n_terms": n_terms,
            "batch_sizes": list(batch_sizes),
            "k": k,
        },
    }
    if cache_path:
        save_cache(report, cache_path)
    return report


def save_cache(report: dict, path: str = DEFAULT_CACHE) -> None:
    """Merge one device's tuning into the on-disk cache (other keys kept)."""
    cache: dict = {}
    try:
        with open(path) as f:
            cache = json.load(f)
    except (OSError, ValueError):
        pass
    cache[report["device"]] = {k: v for k, v in report.items() if k != "device"}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(cache, f, indent=2)


def apply_cache(path: str = DEFAULT_CACHE, device: torch.device | str = "cuda") -> dict | None:
    """Restore this device's tuned tile params from the cache, if present."""
    from repro_torch.kernels.fused_query import dense

    try:
        with open(path) as f:
            cache = json.load(f)
    except (OSError, ValueError):
        return None
    entry = cache.get(device_key(device))
    if not entry or "dense" not in entry:
        return None
    dense.set_tile_params(
        int(entry["dense"]["row_quantum"]), int(entry["dense"]["term_quantum"])
    )
    return entry


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Tune the dense pass's tile quanta on one device")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    print(json.dumps(autotune_dense(device=ap.parse_args().device), indent=2))
