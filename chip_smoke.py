#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) end to end on one card.

    python3 chip_smoke.py              # Robust-scale main path, one card
    python3 chip_smoke.py --docs 52800 # a smaller collection

It needs a CUDA card, ``nvcc`` and the repository checkout it lives in; it
exits non-zero without a result when either is missing.  It prints the
card's name and power limit first, then one JSON line per phase:

  build  the four kernels compiled from ``src/repro_torch/kernels/csrc``
  A      the main path at Robust scale: corpus, inverted index, 300 training
         steps of the membership model, zero-false-negative thresholds, then
         128 conjunctive queries through ``BooleanEngine.query_batch`` at one
         and four shards (Algorithm 3 candidates on the bitset and membership
         kernels, exact verification against the compressed tier-2 store),
         asserted equal to brute force; wall-clock seconds per phase
  B      the verify layer in the learned-codec regime: guided probes and
         full decodes of plm/rmi lists on the guided_search and plm_decode
         kernels, asserted equal to the host numpy probe and decode
  C      each kernel against its plain PyTorch version on the card, on the
         largest inputs phases A and B handed it: the difference, the
         device time (CUDA-graph replay) and the time of calls issued one
         by one, and the bound from its bytes and operations;
         and the time of Algorithm 3's whole candidate step on one batch

then the ``kernels`` line (launch counts from phases A and B, times,
bounds) and, last, ``{"ok": true, "device": {...}}``.  Any failed check
raises, and the script exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet) for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# phase B: the learned-regime collection of benchmarks/guided_intersect.py
B_UNIVERSE = 8_000_000
B_TERMS = 250
B_DF_MAX = 50_000
B_QUERIES = 240
B_FP_RATE = 2e-4
B_SEED = 23

WARMUP, ITERS = 3, 20


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------ phase B data
def _smooth_list(rng, df: int, universe: int):
    import numpy as np

    max_slope = max(2, (universe - 1) // (df + 1) - 1)
    slope = int(rng.integers(min(16, max_slope), min(256, max_slope) + 1))
    noise_hi = max(1, slope // 4)
    start = int(rng.integers(0, universe - df * slope - noise_hi))
    ids = start + np.arange(df, dtype=np.int64) * slope + rng.integers(0, noise_hi, df)
    return ids.astype(np.int32)


def _run_list(rng, df: int, universe: int):
    import numpy as np

    step = int(rng.integers(1, 4))
    start = int(rng.integers(0, universe - df * step - 1))
    return np.arange(start, start + df * step, step, dtype=np.int64).astype(np.int32)


def _rough_list(rng, df: int, universe: int):
    import numpy as np

    return np.sort(rng.choice(universe, size=df, replace=False)).astype(np.int32)


def learned_regime_index(rng):
    """Zipf-df lists: 70% smooth, 15% arithmetic runs, 15% uniform-random
    -> (term_offsets, doc_ids).  Same generator and draw order as
    benchmarks/guided_intersect.py, so the same seed gives the same lists."""
    import numpy as np

    lists = []
    for r in range(B_TERMS):
        df = max(40, int(B_DF_MAX * (r + 1) ** -0.9))
        u = rng.random()
        if u < 0.70:
            ids = _smooth_list(rng, df, B_UNIVERSE)
        elif u < 0.85:
            ids = _run_list(rng, df, B_UNIVERSE)
        else:
            ids = _rough_list(rng, min(df, 4000), B_UNIVERSE)
        lists.append(np.unique(ids))
    offsets = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([len(x) for x in lists], out=offsets[1:])
    return offsets, np.concatenate(lists).astype(np.int32)


def host_probe(tm, cands):
    """The epsilon-window probe of a learned-codec term in host numpy
    (decode each bracket's ranks, compare): the independent check of the
    guided_search kernel's verdicts and ranks."""
    import numpy as np

    from repro_torch.postings.search import decode_window, flatten_windows

    d = np.asarray(cands, np.int64)
    seg, r_lo, _, probe_of, _, ranks = flatten_windows(tm, d)
    if len(ranks) == 0:
        return np.zeros(len(d), bool), r_lo
    ids = decode_window(tm, seg[probe_of], ranks)
    found = np.zeros(len(d), bool)
    np.logical_or.at(found, probe_of, ids == d[probe_of])
    lt = ids < d[probe_of]
    return found, r_lo + np.bincount(probe_of, weights=lt, minlength=len(d)).astype(np.int64)


# ------------------------------------------------------------ helpers
class Recorder:
    """Keeps the largest inputs each kernel wrapper was called with (by
    element count) while the main path runs, for phase C.  It calls the
    wrapper unchanged, so launch counts are the wrapper's own."""

    def __init__(self):
        self.inputs: dict[str, tuple] = {}
        self._size: dict[str, int] = {}

    def wrap(self, module, attr: str, kernel: str) -> None:
        import torch

        fn = getattr(module, attr)

        def recorded(*args):
            size = sum(a.numel() for a in args if isinstance(a, torch.Tensor))
            if size > self._size.get(kernel, -1):
                self._size[kernel], self.inputs[kernel] = size, args
            return fn(*args)

        setattr(module, attr, recorded)


def cuda_ms(fn) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def graph_ms(fn) -> float:
    """Mean device milliseconds per call: ITERS calls captured in one CUDA
    graph and replayed, so the host's launch cost between calls is gone."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(ITERS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    log(f"[C] graph of {ITERS} calls: {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def bits_of(words, n: int):
    """(N, W) int32 packed words -> (N, n) bool, bit i of word w = column 32w+i."""
    import torch

    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :n].bool()


# ------------------------------------------------------------ phases
def phase_a(args, dev, launches, keep: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.common.config import CorpusConfig, LearnedIndexConfig
    from repro_torch.core.learned_bloom import false_negative_rate, fit_thresholds
    from repro_torch.data.corpus import synthesize_corpus
    from repro_torch.data.queries import brute_force_answers, sample_queries, zipf_conjunctions
    from repro_torch.index.build import build_inverted_index
    from repro_torch.launch.serve import train_membership
    from repro_torch.serve import BooleanEngine, ServeConfig

    secs: dict[str, float] = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        log(f"[A] {name}: {secs[name]:.2f}s")
        return out

    ccfg = CorpusConfig(n_docs=args.docs, n_terms=60_000, avg_doc_len=230)
    corpus = timed("corpus", lambda: synthesize_corpus(ccfg))
    inv = timed("index", lambda: build_inverted_index(corpus))
    li_cfg = LearnedIndexConfig(embed_dim=128, block_size=1024)
    model = timed("train", lambda: train_membership(
        corpus, inv, li_cfg, steps=300, batch_size=2048, device=dev, log=log))
    lb = timed("thresholds", lambda: fit_thresholds(model, inv))
    fnr = false_negative_rate(lb, inv)
    if fnr != 0.0:
        raise AssertionError(f"false-negative rate {fnr} != 0")

    q = np.concatenate([
        sample_queries(corpus, 64, seed=3),
        zipf_conjunctions(inv.dfs, 64),
    ]).astype(np.int32)
    exact = timed("oracle", lambda: brute_force_answers(corpus, q))

    shards = {}
    for k in (1, 4):
        eng = BooleanEngine(lb, inv, li_cfg, ServeConfig(n_shards=k, device=str(dev)))
        timed(f"tier2_build_k{k}", lambda: [sh.tier2 for sh in eng.shards])
        before = launches()
        res = timed(f"serve_k{k}", lambda: eng.query_batch(q))
        per_batch = {n: c - before[n] for n, c in launches().items()}
        bad = [i for i, (r, e) in enumerate(zip(res, exact)) if not np.array_equal(r, e)]
        if bad:
            raise AssertionError(f"K={k}: {len(bad)} queries differ from brute force, first {bad[:5]}")
        timed(f"serve_warm_k{k}", lambda: eng.query_batch(q))
        if k == 1:  # for phase C's time of the whole candidate step
            keep["state"], keep["queries"] = eng.shards[0].state, q
        stats = eng.serving_stats()
        shards[f"k{k}"] = {
            "launches_per_batch": per_batch,
            "codecs": eng.shards[0].tier2.codec_histogram(),
            "decode_cache": stats["decode_cache"],
            "guided": stats["guided"],
            "results": int(sum(len(r) for r in res)),
        }
    return {
        "phase": "A",
        "docs": corpus.n_docs,
        "terms": corpus.n_terms,
        "postings": inv.n_postings,
        "queries": int(q.shape[0]),
        "embed_dim": li_cfg.embed_dim,
        "block_size": li_cfg.block_size,
        "false_negative_rate": fnr,
        "exact": True,
        "seconds": secs,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "shards": shards,
    }


def phase_b(dev) -> dict:
    import numpy as np

    from repro_torch.data.queries import zipf_conjunctions
    from repro_torch.index.compress import CODECS
    from repro_torch.index.intersect import membership_mask
    from repro_torch.kernels.plm_decode.ops import decode_lists
    from repro_torch.postings import GuidedPostings, HybridPostings

    rng = np.random.default_rng(B_SEED)
    offsets, doc_ids = learned_regime_index(rng)
    t0 = time.perf_counter()
    store = HybridPostings.build(offsets, doc_ids, B_UNIVERSE)
    build_s = time.perf_counter() - t0
    dfs = np.diff(offsets)
    host = [store.postings(t).astype(np.int64) for t in range(B_TERMS)]  # host numpy decode

    queries = zipf_conjunctions(dfs, B_QUERIES, seed=B_SEED + 1)
    qterms = [sorted((int(t) for t in row if t >= 0), key=lambda t: int(dfs[t])) for row in queries]
    exact = []
    for ts in qterms:
        cur = host[ts[0]]
        for t in ts[1:]:
            cur = np.intersect1d(cur, host[t], assume_unique=True)
        exact.append(cur)
    n_fp = max(16, int(B_FP_RATE * B_UNIVERSE))
    cands = [np.union1d(e, rng.integers(0, B_UNIVERSE, size=n_fp)).astype(np.int64) for e in exact]

    # every plm/rmi term decoded in one batch on the card
    learned_tags = {CODECS.index("plm"), CODECS.index("rmi")}
    learned = [t for t in range(B_TERMS) if store.lens[t] and int(store.tags[t]) in learned_tags]
    t0 = time.perf_counter()
    decoded = decode_lists([store.streams[t][1:] for t in learned],
                           [int(store.lens[t]) for t in learned], device=dev)
    decode_s = time.perf_counter() - t0
    for t, ids in zip(learned, decoded):
        if not np.array_equal(ids, host[t]):
            raise AssertionError(f"plm_decode of term {t} differs from the host decode")

    # conjunctive verification, smallest list first, through the guided prober
    gp = GuidedPostings(store, device=dev)
    t0 = time.perf_counter()
    probes = 0
    for qi, (ts, c) in enumerate(zip(qterms, cands)):
        out = c
        for t in ts:
            if len(out) == 0:
                break
            found, rank = gp.probe(t, out)
            probes += len(out)
            truth_rank = np.searchsorted(host[t], out)
            if not (np.array_equal(found, membership_mask(host[t], out))
                    and np.array_equal(rank, truth_rank)):
                raise AssertionError(f"query {qi} term {t}: probe differs from the host decode")
            if gp.is_guided(t):
                hf, hr = host_probe(gp.term_model(t), out)
                if not (np.array_equal(found, hf) and np.array_equal(rank, hr)):
                    raise AssertionError(f"query {qi} term {t}: probe differs from the host probe")
            out = out[found]
        if not np.array_equal(out, exact[qi]):
            raise AssertionError(f"query {qi}: verified result differs from np.intersect1d")
    verify_s = time.perf_counter() - t0
    return {
        "phase": "B",
        "terms": B_TERMS,
        "postings": int(len(doc_ids)),
        "universe": B_UNIVERSE,
        "queries": B_QUERIES,
        "codecs": store.codec_histogram(),
        "learned_terms": len(learned),
        "probes": probes,
        "probe_stats": gp.stats.as_dict(),
        "exact": True,
        "seconds": {"store_build": build_s, "decode_learned": decode_s, "verify": verify_s},
    }


def phase_c(rec: Recorder, launch_counts: dict) -> list[dict]:
    import torch

    from repro_torch.core.learned_bloom import NUMERIC_MARGIN
    from repro_torch.kernels.bitset.kernel import bitset_and_popcount
    from repro_torch.kernels.bitset.ref import bitset_and_popcount_ref
    from repro_torch.kernels.guided_search.kernel import probe_batch
    from repro_torch.kernels.guided_search.ref import probe_ref
    from repro_torch.kernels.membership.kernel import membership_bitmask
    from repro_torch.kernels.membership.ref import membership_bitmask_ref, membership_logits_ref
    from repro_torch.kernels.plm_decode.kernel import decode_batch
    from repro_torch.kernels.plm_decode.ref import decode_ref

    rows = []

    def row(name, replaces, fn, ref, err, bytes_, flops, library=None, extra=None):
        # ms, plain_ms, library_ms: device time (graph replay); the eager_*
        # keys time the same calls issued one by one from Python
        b_bytes, b_ops = bytes_ / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launch_counts[name], "max_abs_err": err,
            "ms": graph_ms(fn), "plain_ms": graph_ms(ref), "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": graph_ms(library) if library is not None else None,
            "eager_ms": cuda_ms(fn), "plain_eager_ms": cuda_ms(ref),
            **(extra or {}),
        })
        log(f"[C] {rows[-1]}")

    # membership: bits may differ only where |logit - tau| <= NUMERIC_MARGIN (1 + |tau|)
    qe, de, tau, bias = rec.inputs["membership"]
    Q, E = qe.shape
    D = de.shape[0]
    got, want = membership_bitmask(qe, de, tau, bias), membership_bitmask_ref(qe, de, tau, bias)
    logits = membership_logits_ref(qe, de, bias)
    gap = (logits - tau[:, None]).abs()
    near = gap <= NUMERIC_MARGIN * (1 + tau.abs()[:, None])
    differ = bits_of(got ^ want, D)
    outside = int((differ & ~near).sum())
    if outside:
        raise AssertionError(f"membership: {outside} bits differ outside the margin")
    n_differ = int(differ.sum())
    del logits
    row("membership", "src/repro/kernels/membership/kernel.py:41",
        lambda: membership_bitmask(qe, de, tau, bias),
        lambda: membership_bitmask_ref(qe, de, tau, bias),
        float(gap[differ].max()) if n_differ else 0.0,
        4 * (Q * E + D * E + Q + Q * got.shape[1]), 2 * Q * D * E,
        library=lambda: torch.matmul(qe, de.T),
        extra={"shape": {"Q": Q, "D": D, "E": E}, "differing_bits": n_differ,
               "bits_within_margin": int(near.sum()), "margin": NUMERIC_MARGIN})
    del gap, near, differ

    maps, valid = rec.inputs["bitset"]
    (ka, kc), (ra, rc) = bitset_and_popcount(maps, valid), bitset_and_popcount_ref(maps, valid)
    err = max(int((ka.long() - ra.long()).abs().max()), int((kc.long() - rc.long()).abs().max()))
    if err:
        raise AssertionError("bitset differs from its plain version")
    Qb, T, W = maps.shape
    row("bitset", "src/repro/kernels/bitset/kernel.py:49",
        lambda: bitset_and_popcount(maps, valid), lambda: bitset_and_popcount_ref(maps, valid),
        float(err), 4 * (Qb * T * W + Qb * T + Qb * W + Qb), 0,
        extra={"shape": {"Q": Qb, "T": T, "W": W}})

    cols = rec.inputs["guided_search"]
    (kf, kl), (rf, rl) = probe_batch(*cols), probe_ref(*cols)
    err = max(int((kf - rf).abs().max()), int((kl - rl).abs().max()))
    if err:
        raise AssertionError("guided_search differs from its plain version")
    P, Wg = cols[-1].shape
    window = int(cols[4].clamp(max=Wg).sum())  # the kernel reads only each row's valid prefix
    row("guided_search", "src/repro/kernels/guided_search/kernel.py:42",
        lambda: probe_batch(*cols), lambda: probe_ref(*cols),
        float(err), 4 * (6 * P + window + 2 * P), 0,
        extra={"shape": {"P": P, "W": Wg, "window_ranks": window}})

    tabs = rec.inputs["plm_decode"]
    got, want = decode_batch(*tabs), decode_ref(*tabs)
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError("plm_decode differs from its plain version")
    S, N = tabs[0].shape[0], tabs[3].shape[0]  # the batch is ragged: N postings in all
    row("plm_decode", "src/repro/kernels/plm_decode/kernel.py:48",
        lambda: decode_batch(*tabs), lambda: decode_ref(*tabs),
        float(err), 4 * (3 * S + 2 * N), 0,
        extra={"shape": {"S": S, "N": N}})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=528_000,
                    help="documents in phase A's collection (Robust04's 528k by default)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's kernels need one")
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        log(f"chip_smoke: {src / 'repro_torch'} is missing; run from a checkout of the repository")
        return 1
    sys.path.insert(0, str(src))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    # the plain versions and the yardstick are true fp32, like the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from repro_torch.core import algorithms
    from repro_torch.kernels import cuda
    from repro_torch.kernels.bitset.kernel import KERNEL as BITSET
    from repro_torch.kernels.guided_search import ops as guided_ops
    from repro_torch.kernels.guided_search.kernel import KERNEL as GUIDED
    from repro_torch.kernels.membership.kernel import KERNEL as MEMBERSHIP
    from repro_torch.kernels.plm_decode import ops as decode_ops
    from repro_torch.kernels.plm_decode.kernel import KERNEL as DECODE

    kernels = {"membership": MEMBERSHIP, "bitset": BITSET, "guided_search": GUIDED,
               "plm_decode": DECODE}

    t0 = time.perf_counter()
    reports = cuda.build_all()
    for name, text in reports.items():
        log(f"--- nvcc {name}.cu\n{text}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "built": sorted(reports)})

    rec = Recorder()
    rec.wrap(algorithms, "membership_bitmask", "membership")
    rec.wrap(algorithms, "bitset_and_popcount", "bitset")
    rec.wrap(guided_ops, "probe_batch", "guided_search")
    rec.wrap(decode_ops, "decode_batch", "plm_decode")

    def launches() -> dict[str, int]:
        return {n: k.launches for n, k in kernels.items()}

    counts, keep = {}, {}
    for name, run in (("A", lambda: phase_a(args, dev, launches, keep)),
                      ("B", lambda: phase_b(dev))):
        for k in kernels.values():
            k.launches = 0
        result = run()
        counts[name] = launches()
        result["launches"] = counts[name]
        emit(result)
    total = {n: counts["A"][n] + counts["B"][n] for n in kernels}
    missing = [n for n, c in total.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on phases A and B: {missing}")
    for n in ("membership", "bitset"):
        if counts["A"][n] == 0:
            raise AssertionError(f"{n} did not launch on the main path (phase A)")

    rows = phase_c(rec, total)
    # Algorithm 3's whole candidate step on one K=1 batch (both kernels, the
    # block expansion and the AND), beside its kernels' own times
    block_ms = cuda_ms(lambda: algorithms.run_queries(keep["state"], keep["queries"], "block"))
    emit({"phase": "C", "kernels": [r["name"] for r in rows], "launches": total,
          "block_query_ms": block_ms})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
