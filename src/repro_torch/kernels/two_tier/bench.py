#!/usr/bin/env python3
"""Time the two_tier kernel on a synthetic batch shaped like a K=4 shard of
the Robust-like collection (``chip_smoke.py`` phase S).

    python3 src/repro_torch/kernels/two_tier/bench.py                  # this checkout
    python3 src/repro_torch/kernels/two_tier/bench.py --src OTHER/src  # another checkout's kernel

Run it by path: ``--src`` names the directory holding the ``repro_torch``
package to drive, so two versions of the kernel can be timed on one card in
one call (run it once per checkout, in the order parent, change, change,
parent).  The batch, made from ``--seed``: 132,000 docs of 128-float rows,
128 queries of 1 to 5 terms drawn by popularity from 3,000 terms whose
document frequencies fall off as a power law, tier-1 rows of each term's
4,000 lowest doc ids, and thresholds that pass about 70% of each term's
docs.  The kernel's bits must equal its plain version's (``two_tier_ref``)
outside the margin of tau (``--no-check``: only counted, for diagnostic
variants).  One JSON line: the card, the batch's counts,
and twice the device time (20 calls in a CUDA graph, replayed) and the
eager time (the same calls one by one).
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ITERS = 20


def synthetic_batch(seed: int, D: int = 132_000, E: int = 128, k: int = 4000, Q: int = 128,
                    T: int = 8, n_terms: int = 3000):
    """-> numpy (tier1, tier1_len, queries, term_embed, doc_embed, tau), bias."""
    rng = np.random.default_rng(seed)
    df = np.minimum(D, np.maximum(8, (0.4 * D / np.arange(1, n_terms + 1) ** 0.75))).astype(np.int64)
    pop = 1.0 / np.arange(1, n_terms + 1) ** 0.9
    pop /= pop.sum()
    queries = np.full((Q, T), -1, np.int32)
    for q in range(Q):
        w = int(rng.integers(1, 6))
        queries[q, :w] = rng.choice(n_terms, size=w, replace=False, p=pop)
    tier1 = np.full((n_terms, k), D, np.int32)
    lens = np.zeros(n_terms, np.int32)
    for t in np.unique(queries[queries >= 0]):
        ids = np.sort(rng.choice(D, size=int(df[t]), replace=False))[:k]
        tier1[t, : len(ids)] = ids
        lens[t] = len(ids)
    te = (rng.standard_normal((n_terms, E)) * 0.5).astype(np.float32)
    de = (rng.standard_normal((D, E)) * 0.5).astype(np.float32)
    bias = 0.05
    sample = de[rng.choice(D, 2000, replace=False)]
    tau = np.quantile(te @ sample.T + bias, 0.3, axis=1).astype(np.float32)
    return (tier1, lens, queries, te, de, tau), bias


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=Path(__file__).resolve().parents[3],
                    help="the directory that holds the repro_torch package to drive")
    ap.add_argument("--seed", type=int, default=18)
    ap.add_argument("--no-check", action="store_true",
                    help="time a diagnostic variant whose bits are known to differ (rows read "
                         "from elsewhere, no dot products): count the differing bits only")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.core.learned_bloom import NUMERIC_MARGIN
    from repro_torch.kernels.two_tier import kernel
    from repro_torch.kernels.two_tier.ref import tier1_union, two_tier_ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    arrays, bias = synthetic_batch(args.seed)
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    tier1, lens, queries, te, de, tau = t
    D = de.shape[0]
    valid = queries >= 0
    n_entries = int(lens[queries[valid].long()].sum())
    per_query = torch.where(valid, lens[queries.clamp(min=0).long()], 0).sum(1)
    hint = int(per_query.max())
    union = tier1_union(tier1, lens, queries, D)
    counts = {"list_entries": n_entries, "union_pairs": int(union.sum()),
              "distinct_docs": int(union.any(0).sum()), "valid_slots": int(valid.sum()),
              "max_candidates": hint}

    # a version whose grid is sized from the candidates gets them, as
    # core/algorithms.py passes them
    kw = ({"max_candidates": hint} if "max_candidates" in
          inspect.signature(kernel.two_tier_candidates).parameters else {})

    def call():
        return kernel.two_tier_candidates(*t, bias, **kw)

    want = two_tier_ref(*t, bias)
    times = []
    for _ in range(2):
        got = call()
        differ = (got ^ want).view(torch.uint8).cpu().numpy()
        bits = np.unpackbits(differ, axis=-1, bitorder="little")[:, :D]
        for q, d in [] if args.no_check else np.argwhere(bits):
            ts = queries[q][valid[q]].long()
            gap = ((te[ts] * de[d]).sum(-1) + bias - tau[ts]).abs()
            if not bool((gap <= NUMERIC_MARGIN * (1 + tau[ts].abs())).any()):
                raise AssertionError(f"two_tier: bit ({q}, {d}) differs outside the margin")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(ITERS):
                call()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / ITERS
        torch.cuda.synchronize()
        start.record()
        for _ in range(ITERS):
            call()
        end.record()
        torch.cuda.synchronize()
        times.append({"ms": ms, "eager_ms": start.elapsed_time(end) / ITERS,
                      "differing_bits": int(bits.sum())})
    print(json.dumps({"bench": "two_tier", "src": str(args.src), "card": card, **counts,
                      "runs": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
