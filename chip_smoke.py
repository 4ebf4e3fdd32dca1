#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) end to end on one card.

    python3 chip_smoke.py              # Robust-scale main path, one card
    python3 chip_smoke.py --docs 52800 # a smaller collection
    python3 chip_smoke.py --phases ARD --src OTHER/src  # another checkout's package
    python3 chip_smoke.py --phases L   # the LM stack alone
    python3 chip_smoke.py --phases GE  # the GNN and recsys families alone
    python3 chip_smoke.py --phases XW  # the mesh world and the web-scale learned index

It needs a CUDA card, ``nvcc`` and the repository checkout it lives in; it
exits non-zero without a result when either is missing.  It prints the
card's name and power limit first, then one JSON line per phase:

  build  the ten kernels compiled from ``src/repro_torch/kernels/csrc``
  A      the main path at Robust scale: corpus, inverted index, 300 training
         steps of the membership model, zero-false-negative thresholds, then
         128 conjunctive queries through ``BooleanEngine.query_batch`` at one
         and four shards (Algorithm 3 candidates on the masked membership
         launch, which scores only each slot's live blocks, and the bitset
         kernel, exact verification against the compressed tier-2 store,
         optpfd lists decoded on the pfor kernel, a batch's lists in one
         launch), asserted equal to brute force; wall-clock seconds per
         phase, and per batch the decode accounting: lists decoded, calls
         of the shard's decode entry, pfor and plm_decode launches, lists
         the prefetch decoded and the batch never read, host seconds in
         those calls
  B      the verify layer in the learned-codec regime: guided probes and
         full decodes of plm/rmi lists on the guided_search and plm_decode
         kernels, asserted equal to the host numpy probe and decode; the
         240 conjunctions verify term-major, one ``probe_many`` call (one
         guided_search launch) per round, or, in a package without it, one
         ``probe`` call per (query, term); the line names the entry, and
         gives the launches and seconds of the verification
  R      ranked serving, the reference launcher's ranked batch (64 Zipf OR
         queries, top-10) through ``BooleanEngine.query_topk``: on phase A's
         K=1 engine with 8-bit payloads in configuration (a) (multi-phase
         MaxScore, exhaustive queries on bm25_score) and (b) (fused_topk
         launches), (b) again on the K=4 engine, then (a) (cold and warm)
         and (c) (the dense arena loop, with mixed-required queries on
         fused_topk) on the launcher's default collection of 2,000 docs;
         every result list asserted equal to ``brute_force_topk``; per run
         the launches (in a package with ``rank.topk.topk_batch``, every
         (a) batch makes at most one bm25_score launch per shard, asserted)
         and the decode accounting of A; the time of building the 2,000-doc
         shard's guided stream arena on its own
  S      the persistent shard-store and Algorithm 2 on phase A's K=4
         engine after R attached its payloads: ``save`` to a directory
         under ``build/`` (removed at the end; seconds and bytes on disk
         per array kind), ``from_store`` as a block engine that serves A's
         128 queries cold and warm (asserted equal to A's K=4 results) and
         R's (a) ranked batch (asserted equal to brute force), then as a
         two-tier engine (tier-1 lists of the config's 4,000 entries,
         uploaded once, timed on their own) that serves the batch verified,
         cold and warm: every query guaranteed on every shard exact, every
         result a subset of the exact one, at least one guaranteed, one
         two_tier launch per batch and running shard; last, on every
         shard, two_tier == exhaustive AND the tier-1 union, word for word
  D      one list's whole decode through ``postings.search.full_decode``
         (the one-term decode entry of every version of the port): phase A's
         optpfd list closest to 100,000 ids, checked against the host
         decoder; per call, the device time of every kernel, copy and memset
         it issues (torch.profiler) and the host time
  C      each kernel against its plain PyTorch version on the card, on the
         largest inputs phases A, B and R handed it: the difference, the
         device time (CUDA-graph replay) and the time of calls issued one
         by one, and the bound from its bytes and operations; membership
         (Algorithm 1's dense launch) and membership_masked (Algorithm 3's
         live blocks only: its words equal the dense launch's there, word for
         word, zero elsewhere; the bound counts the live pairs) each at A's
         K=1 block batch and at the shape most masked launches saw (the K=4
         shard), the dense launch's rows led by phase W's (case
         ``W_exhaustive_step``: the only shape the path launches it at);
         a second row for fused_topk on the tile with the most true candidates,
         and for pfor and plm_decode on one list of about 100,000 ids
         (``case`` tells the rows apart); bitset is Algorithm 3's fused
         block step (``block_candidates``) at A's K=1 shape, bm25_score
         the stacked exhaustive windows of an (a) batch (and its time on
         the same window one int32 off a 16-byte edge, where it reads
         with 4-byte loads); two_tier on the batch S gave it with the most
         candidates and on its largest inputs (the bits may differ only
         within the margin of tau; its plain version reads a count back,
         so its plain time is eager); dense_topk on phase R's largest dense
         pass and on a synthetic arena at the caps (131,072 docs, 511 terms, 64
         queries, k = 10 and 32), its plain version the PyTorch peel loop;
         mlp_membership at phase M's K=4 shard shape, dense (every logit
         and every bit against its plain version, within the margin), masked
         on M's live-block masks (every live pair scored, the bound counting
         live pairs only) and the two-tier launch on M's batch with the most
         candidates (equal to the dense rows ANDed with the tier-1 union,
         word for word; the bound counting the union's products only)
  Q      the continuous-batching scheduler (``serve.sched.Session``) on
         phase A's K=4 engine with R's payloads: one spawned process
         replica per shard (four workers on the card, each rebuilt from a
         store saved under ``build/``, the kernels built once in this
         process), then inline; A's 128 Boolean queries as single requests
         from 4 client threads (a tenant each), then R's 64 ranked (a)
         queries, all asserted equal to A's K=4 results and R's oracle, none
         shed; wall seconds and requests/s, batches, the median autopsy,
         per-tenant p50/p99 (``slo_report``), each worker's spawn seconds
         (start to ready handshake; its device init and rebuild; warm replay)
         and device MiB (``nvidia-smi``); a traced run (a pid lane per
         worker, ``kernel.*`` spans in them, no nesting violation); a crash
         (the next batch respawns the worker and is exact).  Its launch counts are this process's
         (the inline pass); the workers' launches show as their spans
  M      the MLP head at phase A's width: a ``mlp_hidden=(128,)`` model on
         A's collection, trained as A's (300 steps of 2,048), zero-FN
         thresholds (false-negative rate exactly 0.0, asserted), then A's 128
         queries served from S's saved K=4 store as block and as two-tier
         engines, cold and warm, and once as unverified exhaustive
         candidates: one launch a running shard and batch of the
         algorithm's entry (masked mlp_membership, mlp_two_tier, dense
         mlp_membership) and no other scoring launch, asserted; block
         results equal brute force, two-tier held to the guarantee,
         exhaustive candidates hold every exact result; the head's device
         ms per batch (torch.profiler); two-tier
         == exhaustive AND the tier-1 union on every shard, word for word;
         seconds of training, thresholds, loading and serving, launches and
         probes per run
  K      the port's quickstart (``repro_torch.launch.quickstart``) on the card
         at the reference's size, its 13 steps and their checks
  A_block
         Algorithm 3's candidate step on one of A's K=1 batches, after C
         (its calls are all at that shape): its time (``block_query_ms``),
         launches and device memory allocated per call (one masked membership
         launch, no dense one, one bitset launch and less than a (Q*T, words)
         tensor, asserted where the package has the fused
         ``block_candidates``)
  C_dense
         phase C's dense_topk rows and the dense passes of phases A to S
         (one dense_topk launch a pass, asserted in phase R)
  L      the LM stack (``repro_torch.models``, ``launch/steps.py``,
         ``launch/train.py``), last, once the other phases' engines are
         released: L1 gemma2-2b at full width (2,614M fp32 parameters), two
         seeded prompts of 4,096 tokens prefilled and decoded 8 steps at
         fp32 across the wrap of the 4,096-slot local ring, every step's
         logits against ``lm_logits`` of the whole sequence (2e-3); L2 the
         prefill (2 x 4,096) and decode (batch 16 against a 32,768-deep
         cache) cells in bf16: CUDA-event ms, tokens/s, peak memory; L3
         ``train_loop`` on the train cell at 1 x 4,096, remat "dots", fp32
         Adam moments, 3 steps: step 0's ms apart, loss and grad norm a
         step, peak memory (out of memory, the sequence halves and the line
         says so); L4 deepseek-v2-lite and -v3 at ``reduce_config`` (MLA,
         MoE, MTP): prefill and 3 decode steps against the full forward
         (2e-4), one train step's finite loss; L5 kill-and-resume at
         reduced gemma2-2b, bit for bit.  It launches none of the repo's
         kernels (the reference computes it in XLA ops, not Pallas),
         asserted; the line lists the cuts of the shape cells
  G      MeshGraphNet at full width (15 layers, hidden 128), after L: G1
         the reduced model on seeded numpy weights, the card's forward and
         loss against the port's CPU run (1e-4), and the neighbor sampler
         run twice from one seed on the minibatch_lg graph (232,965 nodes,
         114.6M edges), equal; G2 three train steps (CUDA-event ms, step 0
         apart, loss, peak bytes, and the largest parameter difference
         between two identical step-0 runs: the scatter-add's atomics; a
         4th step's device time by kernel, torch.profiler) on
         minibatch_lg (fanout (15, 10) from 1,024 seeds, padded to 169,984
         nodes and 168,960 edges, d_feat 602), full_graph_sm and molecule;
         ogb_products is a cut (the line says why)
  E      the recsys family: fm, bst and mind at full vocabulary, dlrm-mlperf
         with every table capped at 4,194,304 rows (a cut), each through
         the train (65,536 rows, 3 steps), serve (512 and 262,144 rows) and
         retrieval (1 x 1,000,000 candidates, top-100) cells: ms, rows/s,
         peak bytes, each serve and retrieval cell's bound, the device time
         by kernel of one train step, one serve_bulk and one retrieval call
         (torch.profiler); exactness: a
         reduced config's forward on the card equals the CPU's on the same
         weights, the top-100 is the stable sort (score descending, index
         ascending) of the same scores, and 64 sampled candidates' scores
         equal the forward with the candidate as the target (1e-4 / 1e-5).
         G and E launch none of the repo's kernels (asserted)
  W      the paper's system at ClueWeb09B scale, one rank's share of the
         (16, 16) mesh (``launch/dryrun_learned_index``), after K: a
         3,138,816-doc x 128 bf16 shard and a 60,000-term shard at the shapes
         ``run()`` plans (the allocated bytes asserted equal to its per-rank
         argument bytes); ``exhaustive_step`` on 256 queries x 8 terms (the
         valid slots scored on the dense membership launch, which reads the
         bf16 table in place, ANDed over the terms on bitset),
         its words against the plain versions on the first 65,536 docs and
         on a random 1% of the words, word for word outside NUMERIC_MARGIN of
         tau; ``block_step`` on 64 queries x 64 candidate blocks of 1,024 docs
         (the block AND on bitset, against ``bitset_and_popcount_ref``; the
         candidates' hits against the exhaustive words' bits); ms (CUDA
         events, the first call apart), the device time by kernel of one
         exhaustive call (torch.profiler), peak bytes (absolute, and over
         what the card held before the step), the bound; its
         launches join the kernels line, and its membership call alone
         (row 1c: its words against the plain version on every doc and
         against the launch on the table widened to fp32, word for word;
         device ms from the profile, eager, plain and torch.matmul ms, the
         bound) leads that line's membership rows
  P      the grid dry-run (``launch/dryrun.py``, fake tensors, no card
         memory), its processes started with the run, collected after E:
         (a) on the 16x16 mesh deepseek-v3 ``train_4k``, dlrm-mlperf
         ``train_batch``, meshgraphnet ``ogb_products``, gemma2-2b
         ``prefill_32k`` (a rank's peak under the card's memory) and bst and
         mind ``retrieval_cand`` and mind ``train_batch`` (a rank's peak
         within 2x the reference's plan, held as constants), each ``ok``;
         (b) phase L's gemma2-2b cuts and FM ``train_batch`` on a one-rank
         mesh against the same step on the card: FLOPs equal, peaks within
         20%.  T: ``launch/train_lm.py`` at its defaults
  X      the mesh world, last: 4 ranks spawned on the card with gloo (a
         world of several ranks on one card cannot run NCCL), every
         collective through host memory, bytes counted: X1 the collective
         matmuls at deepseek-v3's dense-FFN width (x 4,096 x 7,168 split over
         k, W 7,168 x 18,432) against ``torch.matmul`` of the whole operands
         (1e-4 relative); X2 the int8 ring all-reduce of 64M fp32 a rank (the
         same bits on every rank, under 5e-2 relative of the exact sum); X3
         GPipe over 4 stages of tanh(x @ W_s) at d 7,168, 8 microbatches of
         512 (1e-5 of the sequential product), and its backward (gradients
         within 1e-5 relative of autograd through that product); X4 deepseek-v3's MoE at full
         width (256 routed experts, 64 a rank, drawn expert by expert from
         their own seeds; top-8, sigmoid gate with bias, the shared expert)
         through ``moe_dispatch`` on a (data 2, model 2) mesh, 2 x 4,096
         tokens, at the config's capacity factor and again at 0.5, which
         drops slots, every output checked after the world exits against
         ``moe_a2a_ref`` in this process (its own routing; 1e-5 + 1e-4
         relative); X5 one full-width attention layer each of gemma2-2b
         (global and local), phi4-mini (``seq`` mode) and deepseek-v2-lite
         (MLA) on a (data 1, model 4) mesh, 2 x 4,096 tokens, fp32, forward
         and backward, its scores split over ``model`` as the reference
         splits them, against the same layer in one process on the card
         (output and every gradient within 1e-5 + 1e-4 relative), each
         rank's peak bytes beside the one process's; X6 MIND's train step
         (a 1,000,000 x 64 table, 65,536 histories of 50), MIND's retrieval
         over 1,000,000 candidates and BST's over 262,144 (a cut: one
         process over 1,000,000 takes 42.5 GB, and the ranks share the card)
         at full width on the same mesh, fp32, the candidates and the item
         tables' rows split over ``model`` (each rank looks up, encodes and
         scores its own candidates; the table's gradient is each rank's
         block), against one process on the card: scores within 1e-5 + 1e-4
         relative, the top-100 ids equal where neighbouring scores stand
         clear of that and none below the 100th by more, the loss within
         1e-5 relative and every gradient within 1e-5 of its largest
         element, each rank's peak bytes over what it held and its host
         bytes; seconds of each part, host bytes, dropped shares, peak
         bytes.  With 4 cards the
         world runs again on NCCL, one rank a card, with a DTensor train step
         of reduced gemma2-2b on a (2, 2) mesh; on one card the line says it
         did not run.  No kernel of the repo launches (asserted in every rank)

then the ``kernels`` line (launch counts from phases A, B, R, S, Q, M, K and
W, times, bounds) and, last, ``{"ok": true, "device": {...}}``.  Any failed
check raises, and the script exits non-zero.  ``--phases`` runs a subset (R
and D need A; S and Q need A and R; M needs A, R and S; C needs A, B and R;
A_block runs with A; L, G, E, W and X need none: ``--phases GE`` runs G and E
alone), ``--src``
drives the package of another checkout (phases A, A_block, B, R and D only
need what every version of the port has; S and C need Algorithm 2's kernel,
and C times dense_topk only in a package that has it),
so that two versions can be compared on one card in one call.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet) for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12  # dense, tensor cores

# phase R: the reference launcher's ranked batch (launch/serve.py), and its
# default collection for the dense arena branch
R_QUERIES = 64
R_TOPK = 10
R_SEED = 7
R_SMALL = dict(n_docs=2000, n_terms=8000, avg_doc_len=80)

# phase B: the learned-regime collection of benchmarks/guided_intersect.py
B_UNIVERSE = 8_000_000
B_TERMS = 250
B_DF_MAX = 50_000
B_QUERIES = 240
B_FP_RATE = 2e-4
B_SEED = 23

WARMUP, ITERS = 3, 20

# the MLP head's entry points beside the dense ``mlp_membership``: kernels-line
# name -> launch counter in kernels/mlp_membership/kernel.py
MLP_ENTRIES = {"mlp_membership_masked": "MASKED", "mlp_two_tier": "TWO_TIER"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def stats_of(eng) -> dict:
    """The engine's metrics snapshot (``serving_stats()`` in a package that
    predates the metrics registry)."""
    metrics = getattr(eng, "metrics", None)
    return metrics.snapshot() if metrics is not None else eng.serving_stats()


T0 = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; phase lines also carry ``t``, the run's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "t": time.perf_counter() - T0}
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
    element count) while the main path runs, for phase C, and, where a kernel
    is given a second measure, the inputs that maximise it too (under
    ``second``).  It calls the wrapper unchanged, so launch counts are the
    wrapper's own."""

    def __init__(self):
        self.inputs: dict[str, tuple] = {}
        self.kwargs: dict[str, dict] = {}
        self.second: dict[str, tuple] = {}
        self._size: dict[str, int] = {}
        self._best: dict[str, int] = {}

    def wrap(self, module, attr: str, kernel, measure=None) -> None:
        """``kernel``: the name the calls are kept under, or a function of
        the call's keywords giving it (one wrapper, two entry points)."""
        import torch

        fn = getattr(module, attr)
        name_of = kernel if callable(kernel) else lambda kwargs: kernel

        def recorded(*args, **kwargs):
            kernel = name_of(kwargs)
            size = sum(a.numel() for a in args if isinstance(a, torch.Tensor))
            if size > self._size.get(kernel, -1):
                self._size[kernel], self.inputs[kernel] = size, args
                self.kwargs[kernel] = kwargs
            if measure is not None:
                m = measure(args)
                if m > self._best.get(kernel, -1):
                    self._best[kernel], self.second[kernel] = m, (args, kwargs)
            return fn(*args, **kwargs)

        setattr(module, attr, recorded)


class DecodeClock:
    """Counts and times the shard's full-decode entry points, whichever of
    ``serve.shard.decode_terms`` (a batch of terms) and
    ``serve.shard.full_decode`` (one term) the package has: calls, lists
    decoded and host seconds (each call ends in the ids' copy to the host)."""

    def __init__(self):
        self.calls = self.lists = 0
        self.seconds = 0.0

    def install(self) -> None:
        from repro_torch.serve import shard

        for name in ("decode_terms", "full_decode"):
            fn = getattr(shard, name, None)
            if fn is not None:
                setattr(shard, name, self._timed(fn, one=name == "full_decode"))

    def _timed(self, fn, one: bool):
        def timed(store, terms, device):
            t0 = time.perf_counter()
            out = fn(store, terms, device)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.lists += 1 if one else len(out)
            return out

        return timed

    def account(self, eng, launches, fn):
        """Run one batch -> (its result, its decode accounting)."""
        import torch

        def unread():  # lists the prefetch decoded and the batch never read
            pre = stats_of(eng).get("prefetch")
            return None if pre is None else pre["unused"]

        calls, lists, secs, before, extra = (self.calls, self.lists, self.seconds,
                                             launches(), unread())
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after, extra_after = launches(), unread()
        return out, {
            "lists_decoded": self.lists - lists, "decode_calls": self.calls - calls,
            "launches": {n: after[n] - before[n] for n in ("pfor", "plm_decode")},
            "extra_prefetched": None if extra is None else extra_after - extra,
            "decode_s": self.seconds - secs, "batch_s": wall,
        }


def shape_frequency():
    """A Recorder measure: how often this call's shapes have been seen so
    far, so the inputs kept are those of the most frequent shapes."""
    from collections import Counter

    seen: Counter = Counter()

    def measure(args) -> int:
        key = tuple(tuple(a.shape) for a in args if hasattr(a, "shape"))
        seen[key] += 1
        return seen[key]

    return measure


def true_candidates(args) -> int:
    """A Recorder measure of a fused_topk tile: its true (query, candidate)
    cells, the candidates that are not NEVER padding."""
    from repro_torch.kernels.fused_query.ref import NEVER

    return int((args[11] != NEVER).sum())


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
def phase_a(args, dev, launches, clock: DecodeClock, keep: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.common.config import CorpusConfig, LearnedIndexConfig
    from repro_torch.core import learned_bloom
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
    fpr = learned_bloom.false_positive_rate(lb, inv) \
        if hasattr(learned_bloom, "false_positive_rate") else None  # an older package has none

    q = np.concatenate([
        sample_queries(corpus, 64, seed=3),
        zipf_conjunctions(inv.dfs, 64),
    ]).astype(np.int32)
    exact = timed("oracle", lambda: brute_force_answers(corpus, q))

    shards, decode = {}, {}

    def served(name, eng):
        before = launches()
        res, decode[name] = clock.account(eng, launches, lambda: eng.query_batch(q))
        secs[name] = decode[name]["batch_s"]
        log(f"[A] {name}: {secs[name]:.2f}s, decode {decode[name]}")
        bad = [i for i, (r, e) in enumerate(zip(res, exact)) if not np.array_equal(r, e)]
        if bad:
            raise AssertionError(f"{name}: {len(bad)} queries differ from brute force, "
                                 f"first {bad[:5]}")
        return {n: c - before[n] for n, c in launches().items()}, res

    for k in (1, 4):
        eng = BooleanEngine(lb, inv, li_cfg, ServeConfig(n_shards=k, device=str(dev)))
        timed(f"tier2_build_k{k}", lambda: [sh.tier2 for sh in eng.shards])
        per_batch, res = served(f"serve_k{k}", eng)
        keep.setdefault("results", {})[k] = res  # phase S serves the batch again
        served(f"serve_warm_k{k}", eng)
        if k == 1:  # for the time of the whole candidate step, at the
            # (Q, max_query_terms) shape the engine hands it
            pad = max(0, eng.cfg.max_query_terms - q.shape[1])
            keep["state"] = eng.shards[0].state
            keep["queries"] = np.pad(q, ((0, 0), (0, pad)), constant_values=-1)
        keep.setdefault("engines", {})[k] = eng  # phase R serves ranked on them
        stats = stats_of(eng)
        shards[f"k{k}"] = {
            "launches_per_batch": per_batch,
            "codecs": eng.shards[0].tier2.codec_histogram(),
            "decode_cache": stats["decode_cache"],
            "guided": stats["guided"],
            "results": int(sum(len(r) for r in res)),
        }
    keep.update(corpus=corpus, inv=inv, lb=lb, li_cfg=li_cfg, batch=q, exact=exact)
    return {
        "phase": "A",
        "docs": corpus.n_docs,
        "terms": corpus.n_terms,
        "postings": inv.n_postings,
        "queries": int(q.shape[0]),
        "embed_dim": li_cfg.embed_dim,
        "block_size": li_cfg.block_size,
        "false_negative_rate": fnr,
        "false_positive_rate": fpr,
        "exact": True,
        "seconds": secs,
        "decode": decode,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "shards": shards,
    }


def phase_b(dev, launches) -> dict:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.queries import zipf_conjunctions
    from repro_torch.index.compress import CODECS
    from repro_torch.index.intersect import membership_mask
    from repro_torch.kernels.guided_search.kernel import KERNEL as GUIDED
    from repro_torch.kernels.pfor.kernel import KERNEL as PFOR
    from repro_torch.kernels.plm_decode.kernel import KERNEL as DECODE
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

    # conjunctive verification, smallest list first, through the guided
    # prober: term-major, one probe_many call per round, where the package
    # has it; else one probe call per (query, term), query after query
    entry = "probe_many" if hasattr(GuidedPostings, "probe_many") else "probe"

    def check(gp, qi, t, out, found, rank):
        truth_rank = np.searchsorted(host[t], out)
        if not (np.array_equal(found, membership_mask(host[t], out))
                and np.array_equal(rank, truth_rank)):
            raise AssertionError(f"query {qi} term {t}: probe differs from the host decode")
        if gp.is_guided(t):
            hf, hr = host_probe(gp.term_model(t), out)
            if not (np.array_equal(found, hf) and np.array_equal(rank, hr)):
                raise AssertionError(f"query {qi} term {t}: probe differs from the host probe")

    def verify(checked: bool):
        """-> (prober, survivors per query, probes, rounds, seconds in the
        prober's calls)"""
        gp = GuidedPostings(store, device=dev)
        outs, probes, rounds, probe_s = list(cands), 0, 0, 0.0
        if entry == "probe_many":
            live, r = [qi for qi in range(len(outs)) if len(outs[qi])], 0
            while live:
                t1 = time.perf_counter()
                res = gp.probe_many([(qterms[qi][r], outs[qi], None) for qi in live])
                probe_s += time.perf_counter() - t1
                rounds += 1
                for qi, (found, rank) in zip(live, res):
                    if checked:
                        check(gp, qi, qterms[qi][r], outs[qi], found, rank)
                    probes += len(outs[qi])
                    outs[qi] = outs[qi][found]
                r += 1
                live = [qi for qi in live if r < len(qterms[qi]) and len(outs[qi])]
        else:
            for qi, ts in enumerate(qterms):
                for t in ts:
                    if len(outs[qi]) == 0:
                        break
                    t1 = time.perf_counter()
                    found, rank = gp.probe(t, outs[qi])
                    probe_s += time.perf_counter() - t1
                    if checked:
                        check(gp, qi, t, outs[qi], found, rank)
                    probes += len(outs[qi])
                    outs[qi] = outs[qi][found]
        return gp, outs, probes, rounds, probe_s

    before = launches()
    t0 = time.perf_counter()
    gp, outs, probes, rounds, probe_s = verify(checked=True)
    for qi, out in enumerate(outs):
        if not np.array_equal(out, exact[qi]):
            raise AssertionError(f"query {qi}: verified result differs from np.intersect1d")
    verify_s = time.perf_counter() - t0
    after = launches()
    # the same verification again, unchecked, under torch.profiler: the
    # device time of every guided_search kernel it runs (launches made to
    # measure are taken back off the counters)
    counters = (GUIDED, DECODE, PFOR)
    saved = [k.launches for k in counters]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        verify(checked=False)
        torch.cuda.synchronize()
    for k, n in zip(counters, saved):
        k.launches = n
    spans = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and "probe_kernel" in e.name]
    return {
        "phase": "B",
        "terms": B_TERMS,
        "postings": int(len(doc_ids)),
        "universe": B_UNIVERSE,
        "queries": B_QUERIES,
        "codecs": store.codec_histogram(),
        "learned_terms": len(learned),
        "entry": entry,
        "rounds": rounds,
        "probes": probes,
        "probe_stats": gp.stats.as_dict(),
        "verify_launches": {n: after[n] - before[n] for n in ("guided_search", "plm_decode")},
        # device ms of the guided_search kernels of one verification
        # (None when the profiler saw no device activity)
        "guided_search_device_ms": sum(spans) if spans else None,
        "guided_search_kernels_profiled": len(spans),
        "exact": True,
        # verify: the whole loop, host checks included; probe: inside the
        # prober's calls only
        "seconds": {"store_build": build_s, "decode_learned": decode_s, "verify": verify_s,
                    "probe": probe_s},
    }


def _check_topk(got, want, what: str) -> None:
    import numpy as np

    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not (np.array_equal(g.ids, w.ids) and np.array_equal(g.scores, w.scores))]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{what}: {len(bad)} ranked results differ from brute force, "
                             f"first {bad[:5]}")


def phase_r(dev, launches, clock: DecodeClock, keep: dict) -> dict:
    """The reference launcher's ranked batch on phase A's engines and on its
    default collection, each configuration asserted equal to brute force."""
    import numpy as np
    import torch

    from repro_torch.common.config import CorpusConfig, LearnedIndexConfig
    from repro_torch.core.learned_bloom import fit_thresholds
    from repro_torch.core.membership import MembershipModel
    from repro_torch.data.corpus import synthesize_corpus
    from repro_torch.data.queries import zipf_disjunctions
    from repro_torch.index.build import build_inverted_index
    from repro_torch.kernels.fused_query import dense
    from repro_torch.postings import search
    from repro_torch.rank import topk
    from repro_torch.rank.score import brute_force_topk
    from repro_torch.serve import BooleanEngine, ServeConfig

    secs: dict[str, float] = {}
    runs: dict[str, dict] = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        log(f"[R] {name}: {secs[name]:.2f}s")
        return out

    def serve(name, eng, queries, oracle, **kw):
        eng.reset_stats()
        before, dense_before = launches(), dense.launches
        got, decode = clock.account(eng, launches, lambda: eng.query_topk(queries, R_TOPK, **kw))
        secs[name] = decode["batch_s"]
        log(f"[R] {name}: {secs[name]:.2f}s")
        _check_topk(got, oracle, name)
        runs[name] = {
            "launches": {n: c - before[n] for n, c in launches().items()},
            "dense_passes": dense.launches - dense_before,
            "ranked_stats": stats_of(eng)["ranked"],
            "decode": decode,
            "results": int(sum(len(r.ids) for r in got)),
        }
        log(f"[R] {name}: {runs[name]}")
        return runs[name]

    # phase A's collection: 528k docs, 60k terms, 8-bit impacts
    inv = keep["inv"]
    eng1, eng4 = keep["engines"][1], keep["engines"][4]
    q, _ = zipf_disjunctions(inv.dfs, R_QUERIES, seed=R_SEED)
    timed("payloads_k1", lambda: [sh.ensure_payloads() for sh in eng1.shards])
    timed("payloads_k4", lambda: [sh.ensure_payloads() for sh in eng4.shards])
    oracle = timed("oracle", lambda: brute_force_topk(inv, eng1.impact_model, q, R_TOPK))
    eng1.cfg.ranked.score_kernel = True  # (a)
    a1 = serve("a_k1", eng1, q, oracle)
    keep["ranked"] = (q, oracle)  # phase S serves (a) again from the store
    eng1.cfg.ranked.score_kernel = False  # (b), as the launcher's --fused sets it
    eng1.cfg.ranked.fused_kernel = True
    eng1.cfg.ranked.topk_exhaustive_cutoff = 0
    b1 = serve("b_k1", eng1, q, oracle)
    eng4.cfg.ranked.fused_kernel = True
    eng4.cfg.ranked.topk_exhaustive_cutoff = 0
    b4 = serve("b_k4", eng4, q, oracle)
    one_score_launch(topk, "a_k1", a1, eng1)
    for name, run, eng in (("b_k1", b1, eng1), ("b_k4", b4, eng4)):
        # at 528k docs no shard fits the arena (132k docs a shard > 2^17):
        # every item goes to fused_topk; a smaller --docs may fit it
        if any(sh.ranked.arena is not None for sh in eng.shards):
            ok = run["dense_passes"] > 0
        else:
            ok = run["launches"]["fused_topk"] > 0 and run["dense_passes"] == 0
        if not ok:
            raise AssertionError(f"{name}: the fused path did not take its kernel: {run}")

    # the launcher's default collection, where a shard fits the dense arena
    ccfg = CorpusConfig(**R_SMALL)
    corpus = timed("small_corpus", lambda: synthesize_corpus(ccfg))
    inv_s = build_inverted_index(corpus)
    li = LearnedIndexConfig(embed_dim=64, truncation_k=64, block_size=128)
    model = MembershipModel.init(li, corpus.n_terms, corpus.n_docs, seed=0, device=dev)
    lb = fit_thresholds(model, inv_s)
    eng_s = BooleanEngine(lb, inv_s, li, ServeConfig(device=str(dev), ranked=dict(
        score_kernel=True)))
    timed("small_tier2", lambda: [(sh.tier2, sh.ensure_payloads()) for sh in eng_s.shards])
    qs, req = zipf_disjunctions(inv_s.dfs, R_QUERIES, seed=R_SEED, n_required=1)
    im = eng_s.impact_model
    small_oracle = brute_force_topk(inv_s, im, qs, R_TOPK)
    one_score_launch(topk, "a_small", serve("a_small", eng_s, qs, small_oracle), eng_s)
    # the same batch warm; and, alone, the build of the guided prober's
    # device arena, which the first batch on an engine pays
    one_score_launch(topk, "a_small_warm", serve("a_small_warm", eng_s, qs, small_oracle), eng_s)
    if hasattr(search, "build_arena"):
        timed("small_stream_arena", lambda: search.build_arena(eng_s.shards[0].tier2, dev))
    eng_s.cfg.ranked.score_kernel = False  # (c): fused with the arena
    eng_s.cfg.ranked.fused_kernel = True
    eng_s.cfg.ranked.topk_exhaustive_cutoff = 0
    timed("small_arena", lambda: eng_s.shards[0].ranked.arena)
    c_or = serve("c_small", eng_s, qs, brute_force_topk(inv_s, im, qs, R_TOPK))
    serve("c_small_mixed", eng_s, qs, brute_force_topk(inv_s, im, qs, R_TOPK, required=req),
          required=req)
    if eng_s.shards[0].ranked.arena is None or c_or["dense_passes"] == 0:
        raise AssertionError("the dense arena path did not run on the small collection")
    for name in ("c_small", "c_small_mixed"):  # a package whose dense pass is a kernel:
        n = runs[name]["launches"].get("dense_topk")  # one launch a pass
        if n is not None and n != runs[name]["dense_passes"]:
            raise AssertionError(f"{name}: {n} dense_topk launches for "
                                 f"{runs[name]['dense_passes']} dense passes")
    keep["dense_arena"] = eng_s.shards[0].ranked.arena
    return {
        "phase": "R",
        "docs": inv.n_docs,
        "terms": inv.n_terms,
        "payload_bits": eng1.shards[0].tier2.payload_bits,
        "queries": R_QUERIES,
        "topk": R_TOPK,
        "small_collection": R_SMALL,
        "exact": True,
        "seconds": secs,
        "runs": runs,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }


def phase_s(dev, launches, clock: DecodeClock, keep: dict) -> dict:
    """The persistent shard-store and Algorithm 2 at phase A's scale: phase
    A's K=4 engine (with R's payloads) saved, reloaded and served as block
    and as two-tier engines; the store directory stays for phase M and is
    removed at the end of the run."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import algorithms as alg
    from repro_torch.kernels.membership.ref import pack_bool_words
    from repro_torch.kernels.two_tier.kernel import KERNEL as TWO_TIER
    from repro_torch.kernels.two_tier.ref import tier1_union
    from repro_torch.launch.serve import check_two_tier
    from repro_torch.serve import BooleanEngine, ServeConfig
    from repro_torch.serve.planner import plan_batch

    secs: dict[str, float] = {}
    runs: dict[str, dict] = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        log(f"[S] {name}: {secs[name]:.2f}s")
        return out

    q, exact = keep["batch"], keep["exact"]
    lb, li_cfg, eng4 = keep["lb"], keep["li_cfg"], keep["engines"][4]

    def served(name, eng):
        """One Boolean batch -> its results; launches, decode accounting and
        the shard's guided-probe counters under runs[name]."""
        eng.reset_stats()
        before = launches()
        res, decode = clock.account(eng, launches, lambda: eng.query_batch(q))
        secs[name] = decode["batch_s"]
        guided = stats_of(eng)["guided"]
        runs[name] = {"launches": {n: c - before[n] for n, c in launches().items()},
                      "decode": decode, "probes": guided["probes"] if guided else 0,
                      "results": int(sum(len(r) for r in res))}
        log(f"[S] {name}: {secs[name]:.2f}s, {runs[name]}")
        return res

    root = ROOT / "build"
    root.mkdir(parents=True, exist_ok=True)
    path = keep["store"] = tempfile.mkdtemp(prefix="chip_smoke_store_", dir=root)  # main removes it
    timed("save", lambda: eng4.save(path))
    disk: dict[str, int] = {}
    for d, _, files in os.walk(path):
        for f in files:
            kind = f[:-4] if f.endswith(".bin") else f
            disk[kind] = disk.get(kind, 0) + os.path.getsize(os.path.join(d, f))

    # block serving from the store: phase A's K=4 results, phase R's (a)
    eng_b = timed("from_store_block", lambda: BooleanEngine.from_store(
        lb, li_cfg, ServeConfig(n_shards=4, device=str(dev), ranked=dict(score_kernel=True)),
        path))
    for name in ("block_cold", "block_warm"):
        res = served(name, eng_b)
        bad = [i for i, (r, e) in enumerate(zip(res, keep["results"][4]))
               if not np.array_equal(r, e)]
        if bad:
            raise AssertionError(f"{name}: {len(bad)} queries differ from phase A's K=4 "
                                 f"results, first {bad[:5]}")
    rq, oracle = keep["ranked"]
    before = launches()
    got, decode = clock.account(eng_b, launches, lambda: eng_b.query_topk(rq, R_TOPK))
    secs["ranked_a"] = decode["batch_s"]
    _check_topk(got, oracle, "S ranked (a) from the store")
    runs["ranked_a"] = {"launches": {n: c - before[n] for n, c in launches().items()},
                        "decode": decode, "ranked_stats": stats_of(eng_b)["ranked"]}
    log(f"[S] ranked_a: {runs['ranked_a']}")
    del eng_b

    # two-tier serving from the store, verified
    eng_t = timed("from_store_two_tier", lambda: BooleanEngine.from_store(
        lb, li_cfg, ServeConfig(algorithm="two_tier", n_shards=4, device=str(dev)), path))
    tier1_bytes = sum(sh.state.tier1_bits // 8 for sh in eng_t.shards)
    timed("tier1_upload", lambda: [sh.state.tier1 for sh in eng_t.shards])
    qpad = eng_t._padded(q)
    plan = plan_batch(qpad, eng_t._global_dfs, eng_t.shards, verified=True)
    running = sum(bool(sp.run.any()) for sp in plan.shard_plans)
    for name in ("two_tier_cold", "two_tier_warm"):
        res = served(name, eng_t)
        guar = check_two_tier(eng_t, q, res, exact, li_cfg.truncation_k)
        n = runs[name]["launches"]["two_tier"]
        if n != running:
            raise AssertionError(f"{name}: {n} two_tier launches for one batch on "
                                 f"{running} shards")
    if not guar.any():
        raise AssertionError("no query is guaranteed on every shard")
    n_exact = sum(np.array_equal(r, e) for r, e in zip(res, exact))

    # the f_hat identity on the card: two_tier == exhaustive AND the
    # tier-1 union, word for word, on every shard (launches taken back)
    saved = launches()
    for sh in eng_t.shards:
        st = sh.state
        got = alg.run_queries(st, qpad, "two_tier")
        union = pack_bool_words(tier1_union(
            st.tier1, st.tier1_len, torch.from_numpy(qpad).to(dev), st.n_docs))
        want = alg.run_queries(st, qpad, "exhaustive") & union
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"shard {sh.shard_id}: {bad} two_tier words differ from "
                                 f"exhaustive AND the tier-1 union")
    for n, k in keep["kernels"].items():
        k.launches = saved[n]
    del eng_t
    return {
        "phase": "S",
        "docs": keep["inv"].n_docs,
        "shards": 4,
        "truncation_k": li_cfg.truncation_k,
        "queries": int(q.shape[0]),
        "disk_bytes": disk,
        "tier1_bytes": tier1_bytes,
        "guaranteed": int(guar.sum()),
        "exact_results": int(n_exact),
        "identity_shards": len(eng4.shards),
        "seconds": secs,
        "runs": runs,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }


def mlp_device_ms(fn):
    """Run ``fn`` under torch.profiler -> (its result, the device ms of the
    MLP head's kernels it issued, by kernel; None when the profiler saw no
    device activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    seen, ms = False, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            seen = True
            for part in ("mlp_rows_kernel", "mlp_two_tier_kernel", "mlp_deep_kernel",
                         "live_items_kernel", "block_and_kernel"):
                if part in e.name:
                    ms[part] = ms.get(part, 0.0) + e.time_range.elapsed_us() / 1e3
    return out, (ms if seen else None)


# phase M: the head's entry point each algorithm launches
M_ENTRY = {"block": "mlp_membership_masked", "two_tier": "mlp_two_tier",
           "exhaustive": "mlp_membership"}


def phase_m(dev, launches, keep: dict) -> dict:
    """The MLP head at phase A's width: a ``mlp_hidden=(128,)`` model
    trained as A's (300 steps of 2,048), zero-FN thresholds, then A's 128
    Boolean queries served from S's saved K=4 store (``from_store``, no
    tier-2 rebuild) as block and as two-tier engines, cold and warm, and
    once as exhaustive candidates (Algorithm 1, unverified).  Each batch
    makes one launch a running shard of its algorithm's entry (masked
    ``mlp_membership``, ``mlp_two_tier``, dense ``mlp_membership``) and no
    other MLP or ``membership``/``two_tier`` launch; block results equal
    brute force, two-tier results are held to the paper's guarantee,
    exhaustive candidates hold every exact result.  Every batch runs under
    torch.profiler for the head's device ms;
    last, on every shard, two-tier == exhaustive AND the tier-1 union, word
    for word (launches taken back)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import algorithms as alg
    from repro_torch.core.learned_bloom import (false_negative_rate, false_positive_rate,
                                                fit_thresholds)
    from repro_torch.kernels.membership.ref import pack_bool_words
    from repro_torch.kernels.two_tier.ref import tier1_union
    from repro_torch.launch.serve import check_two_tier, train_membership
    from repro_torch.serve import BooleanEngine, ServeConfig
    from repro_torch.serve.planner import plan_batch

    secs: dict[str, float] = {}
    runs: dict[str, dict] = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        log(f"[M] {name}: {secs[name]:.2f}s")
        return out

    corpus, inv, q, exact = keep["corpus"], keep["inv"], keep["batch"], keep["exact"]
    li_cfg = dataclasses.replace(keep["li_cfg"], mlp_hidden=(128,))
    model = timed("train", lambda: train_membership(
        corpus, inv, li_cfg, steps=300, batch_size=2048, device=dev, log=log))
    lb = timed("thresholds", lambda: fit_thresholds(model, inv))
    fnr = false_negative_rate(lb, inv)
    if fnr != 0.0:
        raise AssertionError(f"MLP head: false-negative rate {fnr} != 0")
    fpr = false_positive_rate(lb, inv)
    guaranteed = None
    for algorithm in ("block", "two_tier", "exhaustive"):
        cfg = ServeConfig(algorithm=algorithm, n_shards=4, device=str(dev),
                          verified=algorithm != "exhaustive")
        eng = timed(f"from_store_{algorithm}",
                    lambda: BooleanEngine.from_store(lb, li_cfg, cfg, keep["store"]))
        if algorithm == "two_tier":
            timed("tier1_upload", lambda: [sh.state.tier1 for sh in eng.shards])
        qpad = eng._padded(q)
        plan = plan_batch(qpad, eng._global_dfs, eng.shards, verified=cfg.verified)
        running = sum(bool(sp.run.any()) for sp in plan.shard_plans)
        for temp in ("cold", "warm") if algorithm != "exhaustive" else ("cold",):
            name = f"{algorithm}_{temp}"
            eng.reset_stats()
            before = launches()
            # under the profiler: the head's device ms in this batch
            res, device = timed(name, lambda: mlp_device_ms(lambda: eng.query_batch(q)))
            n = {k: c - before[k] for k, c in launches().items() if c != before[k]}
            guided = stats_of(eng).get("guided")  # none without verification
            runs[name] = {"launches": n, "probes": guided["probes"] if guided else 0,
                          "results": int(sum(len(r) for r in res)),
                          "mlp_device_ms": device}
            log(f"[M] {name}: {runs[name]}")
            want = {e: running if e == M_ENTRY[algorithm] else 0
                    for e in ("mlp_membership", *MLP_ENTRIES)}
            if {e: n.get(e, 0) for e in want} != want or n.get("membership") \
                    or n.get("two_tier"):
                raise AssertionError(f"M {name}: launches {n}, expected one "
                                     f"{M_ENTRY[algorithm]} launch on each of {running} running "
                                     f"shards and no other scoring launch")
            if algorithm == "block":
                bad = [i for i, (r, e) in enumerate(zip(res, exact)) if not np.array_equal(r, e)]
                if bad:
                    raise AssertionError(f"M {name}: {len(bad)} queries differ from brute "
                                         f"force, first {bad[:5]}")
            elif algorithm == "two_tier":
                guaranteed = int(check_two_tier(eng, q, res, exact, li_cfg.truncation_k).sum())
            else:  # candidates: no false negative
                bad = [i for i, (r, e) in enumerate(zip(res, exact)) if not np.isin(e, r).all()]
                if bad:
                    raise AssertionError(f"M {name}: {len(bad)} candidate sets miss an exact "
                                         f"result, first {bad[:5]}")
        if algorithm == "two_tier":
            # the head's two-tier launch == its dense rows ANDed over each
            # query's slots and with the tier-1 union, word for word
            saved = launches()
            for sh in eng.shards:
                st = sh.state
                got = alg.run_queries(st, qpad, "two_tier")
                union = pack_bool_words(tier1_union(
                    st.tier1, st.tier1_len, torch.from_numpy(qpad).to(dev), st.n_docs))
                if not torch.equal(got, alg.run_queries(st, qpad, "exhaustive") & union):
                    raise AssertionError(f"M shard {sh.shard_id}: two-tier words differ from "
                                         f"exhaustive AND the tier-1 union")
            for k, kern in keep["kernels"].items():
                kern.launches = saved[k]
        del eng
    return {
        "phase": "M",
        "docs": inv.n_docs,
        "terms": inv.n_terms,
        "shards": 4,
        "queries": int(q.shape[0]),
        "embed_dim": li_cfg.embed_dim,
        "mlp_hidden": list(li_cfg.mlp_hidden),
        "false_negative_rate": fnr,
        "false_positive_rate": fpr,
        "two_tier_guaranteed": guaranteed,
        "exact": True,
        "identity_shards": 4,
        "seconds": secs,
        "runs": runs,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }


def phase_k(dev) -> dict:
    """The port's quickstart (``repro_torch.launch.quickstart``) on the card
    at the reference's size: all 13 steps, each check live."""
    from repro_torch.launch import quickstart

    t0 = time.perf_counter()
    summary = quickstart.run(str(dev), small=False, log=lambda m: log(f"[K] {m}"))
    return {"phase": "K", "steps": 13, "seconds": time.perf_counter() - t0, **summary}


# ------------------------------------------------------------ phase L
# the LM stack at gemma2-2b's full width (configs/gemma2_2b.py)
L_ARCH = "gemma2-2b"
L_SEED = 0
L_PROMPT, L_DECODE = 4096, 8  # decode positions 4,096-4,103 wrap the 4,096-slot local ring
L_TOL = 2e-3  # L1: logits softcapped at 30, fp32 sums over 26 layers in other orders
L_DECODE_CACHE, L_DECODE_BATCH, L_DECODE_STEPS = 32768, 16, 16
L_TRAIN_SEQ, L_TRAIN_STEPS = 4096, 3
L_MLA = ("deepseek-v2-lite-16b", "deepseek-v3-671b")
L_MLA_TOL = 2e-4  # tests/test_models.py's bound for decode against the full forward
# the shape cells of configs/shapes.py and what this phase runs of them
L_CUTS = {
    "prefill_32k": "32 x 32,768 run as 2 x 4,096: the reference's attention holds (B, H, S, S) "
                   "fp32 scores, 34 GB a layer per sequence at 32,768",
    "decode_32k": "global batch 128 run as 16: 128 sequences' caches take 223 GB",
    "train_4k": "global batch 256 run as 1 x 4,096, 3 steps",
}


def _event_ms(fn, warmup: int, iters: int) -> tuple[float, object]:
    """Mean milliseconds a call from CUDA events around ``iters`` calls."""
    import torch

    out = None
    for _ in range(warmup):
        out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


def _device_breakdown(fn, top: int = 8) -> tuple[object, dict | None]:
    """Run ``fn`` once under torch.profiler -> (its result, {device ms of all
    its kernels, host ms of the call, the device's busy share of it, the
    ``top`` kernels by device ms}); None when the profiler saw no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:90]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not by_name:
        return out, None
    device_ms = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return out, {"device_ms": device_ms, "host_ms": host_ms, "busy_share": device_ms / host_ms,
                 "top": [{"kernel": n, "ms": ms} for n, ms in ranked]}


def _lm_bound(cfg, batch: int, s_q: int, s_k: int, *, train: bool = False,
              head_rows: int | None = None, param_bytes: int = 0, cache_bytes: int = 0) -> dict:
    """The least time the card could take for one prefill, decode or train
    step of a GQA transformer at these shapes: its products (the reference's
    (s_q, s_k) score products in fp32, the rest in bf16; forward and the two
    backward products when training; recomputation not counted) at the
    published peaks, against the bytes it must move (the parameters and
    the caches, read once)."""
    d, v = cfg.d_model, cfg.vocab_size
    hd = cfg.resolved_head_dim
    tokens = batch * s_q
    # a GQA block's products: q, k, v, o, then gate, up, down
    body = cfg.n_layers * (d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) + 3 * d * cfg.d_ff)
    head_rows = tokens if head_rows is None else head_rows
    passes = 3 if train else 1
    bf16 = passes * (2 * body * tokens + 2 * v * d * head_rows
                     + 2 * cfg.n_layers * batch * cfg.n_heads * s_q * s_k * hd)  # + P @ V
    fp32 = passes * 2 * cfg.n_layers * batch * cfg.n_heads * s_q * s_k * hd  # Q @ K^T
    ops_ms = (bf16 / BF16_FLOPS + fp32 / FP32_FLOPS) * 1e3
    bytes_ms = (param_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms
            else "bytes", "bf16_flop": bf16, "fp32_flop": fp32, "bytes": param_bytes + cache_bytes}


def _free() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _serve_matches_forward(tf, model, cfg, tokens, n_prompt, steps, max_len, dtype) -> list[float]:
    """Prefill the first ``n_prompt`` tokens, decode the next ``steps`` one at
    a time; each step's logits against ``lm_logits`` of the whole sequence
    at the same position -> the largest absolute difference a step, prefill
    first."""
    import torch

    b = tokens.shape[0]
    caches = tf.init_cache(cfg, b, max_len, dtype, device=tokens.device)
    outs = [tf.lm_prefill(model, cfg, tokens[:, :n_prompt], caches, dtype)[0]]
    for i in range(steps):
        pos = torch.full((b, 1), n_prompt + i, dtype=torch.int32, device=tokens.device)
        tok = tokens[:, n_prompt + i:n_prompt + i + 1]
        outs.append(tf.lm_decode_step(model, cfg, tok, pos, caches, dtype)[0])
    del caches
    with torch.no_grad():
        full = tf.lm_logits(model, cfg, tokens[:, :n_prompt + steps], dtype)
        want = full[:, n_prompt - 1:n_prompt + steps]
        del full
    errs = []
    for i, got in enumerate(outs):
        assert torch.isfinite(got).all(), f"step {i}: non-finite logits"
        errs.append(float((got - want[:, i]).abs().max()))
    return errs


def phase_l(dev) -> dict:
    """The LM stack on the card: serve-path exactness and times, the trainer
    at gemma2-2b's full width, MLA/MoE/MTP at reduced width, kill-and-resume."""
    import itertools

    import numpy as np
    import torch

    from repro_torch.common.config import ShapeSpec, TrainConfig
    from repro_torch.configs import get_arch, reduce_config
    from repro_torch.data.loader import lm_token_batches
    from repro_torch.launch import steps
    from repro_torch.launch.train import train_loop
    from repro_torch.models import transformer as tf
    from repro_torch.train import init_train_state

    cfg = get_arch(L_ARCH)[0]
    out: dict = {"phase": "L", "arch": L_ARCH, "cuts": L_CUTS,
                 "base_allocated_bytes": torch.cuda.memory_allocated()}
    t_all = time.perf_counter()

    # L1: prefill + 8 decode steps at fp32 against the full forward
    _free()
    t0 = time.perf_counter()
    pdtype = steps._lm_param_dtype(cfg)
    model = tf.init_lm(L_SEED, cfg, pdtype, device=dev)[0]
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = next(lm_token_batches(vocab_size=cfg.vocab_size, batch=2,
                                 seq_len=L_PROMPT + L_DECODE, seed=L_SEED))["tokens"]
    toks = torch.from_numpy(toks).to(dev)
    t0 = time.perf_counter()
    errs = _serve_matches_forward(tf, model, cfg, toks, L_PROMPT, L_DECODE, L_PROMPT + L_DECODE,
                                  torch.float32)
    log(f"[L] L1 prefill + {L_DECODE} decode steps vs the full forward: {errs}")
    out["L1"] = {"params": n_params, "param_dtype": str(pdtype), "compute_dtype": "float32",
                 "batch": 2, "prompt": L_PROMPT, "decode_steps": L_DECODE,
                 "max_len": L_PROMPT + L_DECODE, "max_abs_diff": max(errs),
                 "max_abs_diff_per_step": errs, "tolerance": L_TOL,
                 "init_seconds": init_s, "seconds": time.perf_counter() - t0,
                 "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    assert max(errs) <= L_TOL, f"L1: serve path off the full forward by {max(errs)}"

    # L2: the prefill and decode cells in bf16, timed
    _free()
    cell = steps.build_cell(cfg, ShapeSpec(name="prefill_32k", kind="prefill",
                                           seq_len=L_PROMPT, global_batch=2))
    prompt = toks[:, :L_PROMPT].contiguous()
    ms, res = _event_ms(lambda: cell.step(model, prompt), warmup=1, iters=3)
    logits = res[0]
    assert logits.shape == (2, cfg.vocab_size) and torch.isfinite(logits).all()
    del logits, res
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    prefill = {"batch": 2, "seq": L_PROMPT, "ms": ms,
               "tokens_per_s": 2 * L_PROMPT / (ms / 1e3),
               "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
               **_lm_bound(cfg, 2, L_PROMPT, L_PROMPT, head_rows=2, param_bytes=param_bytes)}
    res, prefill["profile"] = _device_breakdown(lambda: cell.step(model, prompt))
    del res
    _free()
    b, s = L_DECODE_BATCH, L_DECODE_CACHE
    cell = steps.build_cell(cfg, ShapeSpec(name="decode_32k", kind="decode", seq_len=s,
                                           global_batch=b))
    caches = tf.init_cache(cfg, b, s, torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(L_SEED)
    new = torch.randint(0, cfg.vocab_size, (b, L_DECODE_STEPS + 2), generator=gen, device=dev,
                        dtype=torch.int32)
    first = s - L_DECODE_STEPS - 2  # the last positions the cache holds
    step_no = itertools.count()

    def decode_one():
        i = next(step_no)
        pos = torch.full((b, 1), first + i, dtype=torch.int32, device=dev)
        return cell.step(model, new[:, i:i + 1], pos, caches)

    ms, res = _event_ms(decode_one, warmup=1, iters=L_DECODE_STEPS)
    logits = res[0]
    assert logits.shape == (b, cfg.vocab_size) and torch.isfinite(logits).all()
    cache_bytes = sum(c.k.numel() * 2 + c.v.numel() * 2 for c in caches)
    decode = {"batch": b, "cache_len": s, "steps": L_DECODE_STEPS,
              "ms_per_step": ms, "tokens_per_s": b / (ms / 1e3), "cache_bytes": cache_bytes,
              "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
              **_lm_bound(cfg, b, 1, s, param_bytes=param_bytes, cache_bytes=cache_bytes)}
    del logits, res
    res, decode["profile"] = _device_breakdown(decode_one)  # one step more, profiled
    out["L2"] = {"compute_dtype": "bfloat16", "prefill": prefill, "decode": decode}
    del res, caches, cell, model, decode_one
    log(f"[L] L2 {out['L2']}")

    # L3: the trainer (launch/train.py:train_loop) at full width
    ckpt = ROOT / "build" / "phase_l_ckpt"
    out["L3"] = []
    seq = L_TRAIN_SEQ
    while True:
        _free()
        log(f"[L] L3 at seq {seq}: {torch.cuda.memory_allocated()} bytes allocated before")
        cell = steps.build_cell(cfg, ShapeSpec(name="train_4k", kind="train", seq_len=seq,
                                               global_batch=1), remat="dots")
        hist: list = []
        shutil.rmtree(ckpt, ignore_errors=True)  # no checkpoint to resume from, none written
        tcfg = TrainConfig(steps=L_TRAIN_STEPS, checkpoint_dir=str(ckpt), checkpoint_every=0,
                           log_every=1, seed=L_SEED)
        data = lm_token_batches(vocab_size=cfg.vocab_size, batch=1, seq_len=seq, seed=L_SEED)
        t0 = time.perf_counter()
        try:
            trained, opt, _ = train_loop(cell, tcfg, data_it=data, device=dev, history=hist)
        except torch.cuda.OutOfMemoryError as e:  # say so, and halve the sequence
            msg = str(e).splitlines()[0]
            out["L3"].append({"seq": seq, "out_of_memory": msg,
                              "peak_allocated_bytes": torch.cuda.max_memory_allocated()})
            log(f"[L] L3 at seq {seq}: out of memory ({msg}); halving")
            del e
            seq //= 2
            if seq < 1024:
                raise
            continue
        run = {"seq": seq, "batch": 1, "remat": "dots", "moments": cell.opt_cfg.moment_dtype,
               "params": sum(p.numel() for p in trained.parameters()),
               "seconds": time.perf_counter() - t0,
               "step0_ms": hist[0]["ms"], "ms_per_step": float(np.mean([h["ms"] for h in hist[1:]])),
               "loss": [h["loss"] for h in hist], "grad_norm": [h["grad_norm"] for h in hist],
               "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
               **_lm_bound(cfg, 1, seq, seq, train=True)}
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        _, run["profile"] = _device_breakdown(lambda: cell.step(trained, opt, batch))  # a 4th step
        out["L3"].append(run)
        del trained, opt, cell, batch
        assert len(hist) == L_TRAIN_STEPS and all(
            np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist), hist
        break
    log(f"[L] L3 {out['L3']}")

    # L4: MLA, MoE and MTP at reduced width
    _free()
    out["L4"] = {}
    for arch in L_MLA:
        rc = reduce_config(get_arch(arch)[0])
        small = tf.init_lm(L_SEED, rc, torch.float32, device=dev)[0]
        rng = np.random.default_rng(L_SEED)
        tokens = torch.from_numpy(rng.integers(0, rc.vocab_size, (2, 23)).astype(np.int32)).to(dev)
        errs = _serve_matches_forward(tf, small, rc, tokens, 20, 3, 32, torch.float32)
        cell = steps.build_cell(rc, ShapeSpec(name="train", kind="train", seq_len=32, global_batch=2))
        trained = cell.init_fn(L_SEED, dev)
        opt = init_train_state(trained, cell.opt_cfg)
        batch = next(lm_token_batches(vocab_size=rc.vocab_size, batch=2, seq_len=32, seed=L_SEED))
        m = cell.step(trained, opt, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        loss = float(m["loss"])
        out["L4"][arch] = {"max_abs_diff": max(errs), "tolerance": L_MLA_TOL, "train_loss": loss,
                           "param_dtype": str(steps._lm_param_dtype(rc)),
                           "moments": cell.opt_cfg.moment_dtype, "mtp": rc.use_mtp}
        assert max(errs) <= L_MLA_TOL, f"L4 {arch}: decode off the full forward by {max(errs)}"
        assert np.isfinite(loss), f"L4 {arch}: loss {loss}"
        del small, trained, opt
    log(f"[L] L4 {out['L4']}")

    # L5: kill-and-resume at reduced width, bit for bit
    _free()
    rc = reduce_config(cfg)
    cell = steps.lm_cell(rc, ShapeSpec(name="train", kind="train", seq_len=64, global_batch=2))
    batches = list(itertools.islice(lm_token_batches(vocab_size=rc.vocab_size, batch=2, seq_len=64,
                                                     seed=L_SEED), 4))
    shutil.rmtree(ckpt, ignore_errors=True)

    def tc(n, name, every):
        return TrainConfig(steps=n, checkpoint_dir=str(ckpt / name), checkpoint_every=every,
                           log_every=100, seed=L_SEED)

    try:
        straight, opt_a, _ = train_loop(cell, tc(4, "a", 0), data_it=iter(batches), device=dev)
        train_loop(cell, tc(2, "b", 2), data_it=iter(batches[:2]), device=dev)
        resumed, opt_b, _ = train_loop(cell, tc(4, "b", 2), data_it=iter(batches[2:]), device=dev)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    sd_a, sd_b = straight.state_dict(), resumed.state_dict()
    differ = [n for n in sd_a if not torch.equal(sd_a[n], sd_b[n])]
    out["L5"] = {"steps": 4, "checkpoint_step": 2, "tensors": len(sd_a), "differing": differ,
                 "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
                 "optimizer_step": [opt_a.step, opt_b.step]}
    assert opt_a.step == opt_b.step == 4 and not differ, f"L5: resumed run differs in {differ}"
    out["seconds"] = time.perf_counter() - t_all
    return out


# ------------------------------------------------------------ phases G and E
# the GNN and recsys families (models/{gnn,recsys,sampler}.py, their cells)
G_ARCH = "meshgraphnet"
G_SEED = 0
G_STEPS = 3
G_TOL = 1e-4  # G1: card vs CPU, fp32 sums (matmuls, LayerNorm, atomic scatter-add) in other orders
G_MINIBATCH_DEGREE = 492  # 232,965 nodes x 492 = the shape's 114.6M edges
G_CUTS = {
    "ogb_products": "61,859,140 edges: the edge MLP's (E, 384) fp32 input alone is 95 GB, "
                    "more than one card holds; it waits for the mesh slice",
}
E_ARCHS = ("fm", "bst", "mind", "dlrm-mlperf")
E_SEED = 0
E_STEPS = 3
E_DLRM_CAP = 4_194_304  # rows a DLRM table keeps on one card
E_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_models.py's retrieval-vs-forward bound
E_CHECK_CANDIDATES = 64
E_CUTS = {
    "dlrm-mlperf": f"every table capped at {E_DLRM_CAP:,} rows (25.0M of 187.8M, 12.8 GB): the "
                   "full 96.1 GB of tables does not fit one card, even to serve",
}


def _numpy_state(model, seed: int) -> dict:
    """Seeded numpy weights for every tensor of ``model``'s state dict, by
    name: tables 0.1 N, LayerNorm scales 1 + 0.1 N, biases 0.1 N, BST's
    ``wo`` N / sqrt(H * d/H), other weights N / sqrt(fan-in)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = {}
    for n, p in model.state_dict().items():
        leaf, z = n.split(".")[-1], rng.standard_normal(tuple(p.shape))
        if n.split(".")[0] in ("tables", "linear", "item_table", "pos_table"):
            z = 0.1 * z
        elif leaf == "scale":
            z = 1.0 + 0.1 * z
        elif leaf in ("b", "bias", "w0", "b_init"):
            z = 0.1 * z
        elif leaf == "wo":
            z = z / np.sqrt(p.shape[0] * p.shape[1])
        else:
            z = z / np.sqrt(p.shape[0])
        out[n] = torch.from_numpy(np.asarray(z, dtype=np.float32))
    return out


def _carried(init, cfg, dev, seed: int):
    """(the model on the CPU, the same on the card), both holding the same
    seeded numpy weights."""
    cpu = init(seed, cfg, device="cpu")[0]
    state = _numpy_state(cpu, seed)
    cpu.load_state_dict(state)
    card = init(seed, cfg, device=dev)[0]
    card.load_state_dict(state)
    return cpu, card


def _max_diff(a, b) -> float:
    return float((a.detach().cpu().double() - b.detach().cpu().double()).abs().max())


def _step_ms(step, n: int) -> tuple[list[float], list]:
    """Run ``step`` n times -> (CUDA-event ms of each call, their results)."""
    import torch

    times, outs = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(step())
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, outs


def _graph_batch(n: int, e: int, d_feat: int, cfg, n_valid: int, e_valid: int, gen, dev,
                 senders=None, receivers=None) -> dict:
    """A padded graph on the card: seeded features and targets, the first
    ``n_valid`` nodes and ``e_valid`` edges real; uniform endpoints unless
    given."""
    import torch

    def pad(ids, size):
        out = torch.zeros(size, dtype=torch.int32, device=dev)
        out[:len(ids)] = ids
        return out

    if senders is None:
        senders = torch.randint(0, n_valid, (e_valid,), generator=gen, device=dev)
        receivers = torch.randint(0, n_valid, (e_valid,), generator=gen, device=dev)
    node_mask = torch.zeros(n, device=dev)
    node_mask[:n_valid] = 1.0
    edge_mask = torch.zeros(e, device=dev)
    edge_mask[:e_valid] = 1.0
    return {
        "node_feat": torch.randn((n, d_feat), generator=gen, device=dev),
        "edge_feat": torch.randn((e, cfg.edge_feat_dim), generator=gen, device=dev),
        "senders": pad(senders, e), "receivers": pad(receivers, e),
        "node_mask": node_mask, "edge_mask": edge_mask,
        "node_targets": torch.randn((n, cfg.gnn_out_dim), generator=gen, device=dev),
    }


def phase_g(dev) -> dict:
    """MeshGraphNet at full width on the card: the reduced model against the
    port's CPU run, the sampler's determinism, then three train steps on
    each of minibatch_lg (sampled from a 114.6M-edge graph), full_graph_sm
    and molecule."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch, reduce_config
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.launch import steps
    from repro_torch.models import gnn, sampler
    from repro_torch.train import init_train_state

    t_all = time.perf_counter()
    cfg = get_arch(G_ARCH)[0]
    out: dict = {"phase": "G", "arch": G_ARCH, "cuts": G_CUTS, "tolerance": G_TOL,
                 "base_allocated_bytes": torch.cuda.memory_allocated()}

    # G1: the reduced model, the same seeded numpy weights on the CPU and the card
    _free()
    rc = reduce_config(cfg)
    cpu, card = _carried(gnn.init_mgn, rc, dev, G_SEED)
    gen = torch.Generator(device="cpu").manual_seed(G_SEED)
    batch = _graph_batch(2048, 8192, rc.node_feat_dim, rc, 2000, 8000, gen, "cpu")
    with torch.no_grad():
        want_out, want_loss = gnn.mgn_forward(cpu, rc, batch), gnn.mgn_loss(cpu, rc, batch)
        on_card = {k: v.to(dev) for k, v in batch.items()}
        got_out, got_loss = gnn.mgn_forward(card, rc, on_card), gnn.mgn_loss(card, rc, on_card)
    g1 = {"config": "reduce_config", "nodes": 2048, "edges": 8192,
          "forward_max_abs_diff": _max_diff(got_out, want_out),
          "loss": float(got_loss), "loss_abs_diff": abs(float(got_loss) - float(want_loss))}
    assert torch.isfinite(got_out).all() and g1["forward_max_abs_diff"] <= G_TOL \
        and g1["loss_abs_diff"] <= G_TOL, f"G1: card off the CPU: {g1}"
    del cpu, card, batch, on_card

    # the minibatch_lg graph, and its sampler run twice from one seed
    shape = {s.name: s for s in GNN_SHAPES}
    mb = shape["minibatch_lg"]
    t0 = time.perf_counter()
    graph = sampler.CSRGraph.random(mb.n_nodes, avg_degree=G_MINIBATCH_DEGREE, seed=G_SEED)
    graph_s = time.perf_counter() - t0
    max_n, max_e = sampler.subgraph_budget(mb.batch_nodes, mb.fanout)
    roots = np.random.default_rng(G_SEED).choice(mb.n_nodes, mb.batch_nodes, replace=False)
    samples, sample_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        samples.append(sampler.sample_subgraph(graph, roots, mb.fanout, max_nodes=max_n,
                                               max_edges=max_e,
                                               rng=np.random.default_rng(G_SEED)))
        sample_s.append(time.perf_counter() - t0)
    same = all(np.array_equal(samples[0][k], samples[1][k]) for k in samples[0])
    g1["sampler_deterministic"] = same
    assert same, "G1: two samples from one seed differ"
    out["G1"] = g1
    sub = samples[0]
    del samples
    log(f"[G] G1 {g1}")

    # G2: three train steps a shape at full width
    out["G2"] = {}
    for name in ("minibatch_lg", "full_graph_sm", "molecule"):
        _free()
        sh = shape[name]
        cell = steps.build_cell(cfg, sh)
        n, e, d_feat = steps.gnn_graph_dims(sh)
        gen = torch.Generator(device=dev).manual_seed(G_SEED)
        run: dict = {"nodes": n, "edges": e, "d_feat": d_feat}
        if name == "minibatch_lg":
            nv, ev = int(sub["node_mask"].sum()), int(sub["edge_mask"].sum())
            snd = torch.from_numpy(sub["senders"][:ev]).to(dev)
            rcv = torch.from_numpy(sub["receivers"][:ev]).to(dev)
            run.update({"graph_edges": int(graph.indptr[-1]), "graph_seconds": graph_s,
                        "sampler_seconds": sample_s, "valid_nodes": nv, "valid_edges": ev})
        elif name == "molecule":
            # 128 graphs of 30 nodes and 64 edges, edges within each graph
            g_of = torch.arange(sh.n_graphs, device=dev).repeat_interleave(sh.n_edges)
            snd = g_of * sh.n_nodes + torch.randint(0, sh.n_nodes, (len(g_of),), generator=gen,
                                                    device=dev)
            rcv = g_of * sh.n_nodes + torch.randint(0, sh.n_nodes, (len(g_of),), generator=gen,
                                                    device=dev)
            nv, ev = sh.n_nodes * sh.n_graphs, len(g_of)
        else:
            snd = rcv = None
            nv, ev = sh.n_nodes, sh.n_edges
        batch = _graph_batch(n, e, d_feat, cell.arch, nv, ev, gen, dev, snd, rcv)
        model = cell.init_fn(G_SEED, dev)
        opt = init_train_state(model, cell.opt_cfg)
        times, metrics = _step_ms(lambda: cell.step(model, opt, batch), 1)
        after0 = {k: v.clone() for k, v in model.state_dict().items()}
        more, metrics2 = _step_ms(lambda: cell.step(model, opt, batch), G_STEPS - 1)
        times, metrics = times + more, metrics + metrics2
        run.update({
            "remat": n > 500_000, "params": sum(p.numel() for p in model.parameters()),
            "step0_ms": times[0], "ms_per_step": float(np.mean(times[1:])), "step_ms": times,
            "loss": [float(m["loss"]) for m in metrics],
            "grad_norm": [float(m["grad_norm"]) for m in metrics],
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        })
        assert all(np.isfinite(run["loss"])) and all(np.isfinite(run["grad_norm"])), run
        _, run["profile"] = _device_breakdown(lambda: cell.step(model, opt, batch))  # a 4th step
        # step 0 again on an identical model: the atomics may differ in the last bits
        twin = cell.init_fn(G_SEED, dev)
        cell.step(twin, init_train_state(twin, cell.opt_cfg), batch)
        run["step0_twin_max_param_diff"] = max(_max_diff(v, after0[k])
                                               for k, v in twin.state_dict().items())
        out["G2"][name] = run
        log(f"[G] G2 {name} {run}")
        del model, opt, twin, after0, metrics, batch, cell
    out["seconds"] = time.perf_counter() - t_all
    return out


def _mlp_flop(dims) -> int:
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def _rec_bound(cfg, rows: int, *, retrieval: bool, weight_bytes: int) -> dict:
    """The least time the card could take for one serve call of ``rows``
    rows, or one retrieval over ``rows`` candidates, at the published fp32
    peak and memory rate: the products of the forward a row (a retrieval
    candidate: what the candidate changes, the user's side counted once),
    against the bytes read once (each row's ids and gathered table rows,
    the dense weights) and written once (a score a row; retrieval writes
    only its top-100)."""
    f = 4  # fp32 bytes
    if cfg.name == "dlrm-mlperf":
        n_f, d = cfg.n_sparse + 1, cfg.embed_dim
        top = _mlp_flop([n_f * (n_f - 1) // 2 + cfg.bot_mlp[-1], *cfg.top_mlp])
        if retrieval:
            flop, per_row = 2 * (n_f - 1) * d + top, 4 + d * f
        else:
            flop = _mlp_flop([cfg.n_dense, *cfg.bot_mlp]) + 2 * (n_f * (n_f - 1) // 2) * d + top
            per_row = cfg.n_dense * f + cfg.n_sparse * (4 + d * f) + f
    elif cfg.name == "fm":
        k = cfg.embed_dim
        if retrieval:
            flop, per_row = 2 * k + 2, 4 + (k + 1) * f
        else:
            flop, per_row = 4 * cfg.n_sparse * k + cfg.n_sparse, cfg.n_sparse * (4 + (k + 1) * f) + f
    elif cfg.name == "bst":
        s, d, h = cfg.hist_len + 1, cfg.embed_dim, cfg.n_heads
        attn = 2 * 2 * h * s * s * (d // h) + 2 * s * d * d + _mlp_flop([d, 4 * d, d]) * s
        head = _mlp_flop([s * d, *cfg.top_mlp, 1])
        if retrieval:  # the history's Q/K/V projections do not depend on the candidate
            flop, per_row = 3 * 2 * d * d + attn + head, 4 + d * f
        else:
            flop, per_row = 3 * 2 * s * d * d + attn + head, s * (4 + d * f) + f
    else:  # mind
        L, d, j = cfg.hist_len, cfg.embed_dim, cfg.n_interests
        if retrieval:
            flop, per_row = 2 * j * d, 4 + d * f
        else:
            flop = 2 * L * d * d + cfg.capsule_iters * 2 * (2 * j * L * d) + 2 * j * d
            per_row = (L + 1) * (4 + d * f) + f
    ops_ms = rows * flop / FP32_FLOPS * 1e3
    bytes_ = rows * per_row + weight_bytes
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms
            else "bytes", "fp32_flop": rows * flop, "bytes": bytes_}


def _rec_batch(cfg, b: int, gen, dev, *, label: bool = True, target: bool = True) -> dict:
    """A recsys batch on the card, ids uniform over each field's vocabulary."""
    import torch

    def ids(v, shape):
        return torch.randint(0, v, shape, generator=gen, device=dev).to(torch.int32)

    out = {}
    if cfg.name == "dlrm-mlperf":
        out["dense"] = torch.randn((b, cfg.n_dense), generator=gen, device=dev)
    if cfg.name in ("dlrm-mlperf", "fm"):
        out["sparse"] = torch.stack([ids(v, (b,)) for v in cfg.vocab_sizes], dim=1)
    else:
        out["hist"] = ids(cfg.vocab_sizes[0], (b, cfg.hist_len))
        if target:
            out["target"] = ids(cfg.vocab_sizes[0], (b,))
    if label:
        out["label"] = torch.randint(0, 2, (b,), generator=gen, device=dev).float()
    return out


def _swapped(cfg, user: dict, cands) -> dict:
    """The user's context once per candidate, the candidate as its target
    (sparse field 0 for DLRM and FM)."""
    rows = {k: v.expand(len(cands), *v.shape[1:]).clone() for k, v in user.items()}
    if "sparse" in rows:
        rows["sparse"][:, 0] = cands
    else:
        rows["target"] = cands
    return rows


def phase_e(dev) -> dict:
    """The recsys family on the card: FM, BST and MIND at full vocabulary,
    DLRM at its cap, each through the train, serve and retrieval cells, with
    the exactness checks."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch, reduce_config
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.launch import steps
    from repro_torch.models import recsys
    from repro_torch.train import init_train_state

    t_all = time.perf_counter()
    shapes = {s.name: s for s in RECSYS_SHAPES}
    out: dict = {"phase": "E", "cuts": E_CUTS, "tolerance": E_TOL,
                 "base_allocated_bytes": torch.cuda.memory_allocated(), "archs": {}}
    for arch in E_ARCHS:
        t_arch = time.perf_counter()
        cfg = get_arch(arch)[0]
        if arch == "dlrm-mlperf":
            cfg = cfg.replace(vocab_sizes=tuple(min(v, E_DLRM_CAP) for v in cfg.vocab_sizes))
        res: dict = {"vocab_rows": sum(cfg.vocab_sizes)}
        gen = torch.Generator(device=dev).manual_seed(E_SEED)

        # a reduced config on the card against the port's CPU run
        _free()
        rc = reduce_config(get_arch(arch)[0])
        cpu, card = _carried(recsys.INIT[arch], rc, dev, E_SEED)
        small = {k: v.cpu() for k, v in _rec_batch(rc, 256, gen, dev).items()}
        for k in ("sparse", "hist", "target"):  # ids of -1 and >= V: every lookup clamps
            if k in small:
                small[k].view(-1)[:8] = torch.tensor([-1, -5, 10**6, 2**30, 0, 1, 999, 1000])
        with torch.no_grad():
            want = recsys.FORWARD[arch](cpu, rc, small)
            got = recsys.FORWARD[arch](card, rc, {k: v.to(dev) for k, v in small.items()})
        res["reduced_card_vs_cpu_max_abs"] = _max_diff(got, want)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **E_TOL,
                                   err_msg=f"E {arch}: reduced forward, card against the CPU")
        del cpu, card

        # train_batch: three steps from the train cell at full width
        _free()
        cell = steps.build_cell(cfg, shapes["train_batch"])
        t0 = time.perf_counter()
        model = cell.init_fn(E_SEED, dev)
        torch.cuda.synchronize()
        res["init_seconds"] = time.perf_counter() - t0
        res["params"] = sum(p.numel() for p in model.parameters())
        res["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
        opt = init_train_state(model, cell.opt_cfg)
        b = shapes["train_batch"].global_batch
        batch = _rec_batch(cfg, b, gen, dev)
        times, metrics = _step_ms(lambda: cell.step(model, opt, batch), E_STEPS)
        res["train"] = {"batch": b, "step0_ms": times[0], "ms_per_step": float(np.mean(times[1:])),
                        "step_ms": times, "loss": [float(m["loss"]) for m in metrics],
                        "grad_norm": [float(m["grad_norm"]) for m in metrics],
                        "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        assert all(np.isfinite(res["train"]["loss"])), res["train"]
        _, res["train"]["profile"] = _device_breakdown(lambda: cell.step(model, opt, batch))
        model.zero_grad(set_to_none=True)
        del opt, metrics, batch, cell
        weight_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                           if n.split(".")[0] not in ("tables", "linear", "item_table"))

        # serve_p99 and serve_bulk
        for name, iters in (("serve_p99", 20), ("serve_bulk", 3)):
            _free()
            b = shapes[name].global_batch
            cell = steps.build_cell(cfg, shapes[name])
            batch = _rec_batch(cfg, b, gen, dev, label=False)
            ms, scores = _event_ms(lambda: cell.step(model, batch), warmup=1, iters=iters)
            assert scores.shape == (b,) and torch.isfinite(scores).all(), name
            res[name] = {"batch": b, "ms": ms, "rows_per_s": b / (ms / 1e3),
                         "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                         **_rec_bound(cfg, b, retrieval=False, weight_bytes=weight_bytes)}
            if name == "serve_bulk":
                _, res[name]["profile"] = _device_breakdown(lambda: cell.step(model, batch))
            del batch, scores, cell

        # retrieval_cand: one user against 1,000,000 candidates, top-100
        _free()
        sh = shapes["retrieval_cand"]
        cell = steps.build_cell(cfg, sh)
        c = sh.n_candidates
        user = _rec_batch(cfg, 1, gen, dev, label=False, target=False)
        v0 = cfg.vocab_sizes[0]
        cands = (torch.arange(c, device=dev) if v0 == c else
                 torch.randint(0, v0, (c,), generator=gen, device=dev)).to(torch.int32)
        batch = {**user, "candidates": cands}
        ms, (vals, ids) = _event_ms(lambda: cell.step(model, batch), warmup=1, iters=3)
        res["retrieval_cand"] = {
            "candidates": c, "ms": ms, "candidates_per_s": c / (ms / 1e3),
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
            "top100_candidates": cands[ids.long()].tolist(), "top100_scores": vals.tolist(),
            **_rec_bound(cfg, c, retrieval=True, weight_bytes=weight_bytes)}
        _, res["retrieval_cand"]["profile"] = _device_breakdown(lambda: cell.step(model, batch))
        # exactness: the top-100 is the stable sort of the same scores, and a
        # candidate's score is the forward with it as the target
        with torch.no_grad():
            scores = recsys.RETRIEVAL[arch](model, cfg, user, cands)
            s_np = scores.cpu().numpy()
            order = np.lexsort((np.arange(c), -s_np))[:100]
            assert np.array_equal(ids.cpu().numpy(), order), f"E {arch}: top-100 ids"
            assert np.array_equal(vals.cpu().numpy(), s_np[order]), f"E {arch}: top-100 scores"
            pos = torch.randint(0, c, (E_CHECK_CANDIDATES,), generator=gen, device=dev)
            fwd = recsys.FORWARD[arch](model, cfg, _swapped(cfg, user, cands[pos]))
            res["retrieval_vs_forward_max_abs"] = _max_diff(scores[pos], fwd)
            np.testing.assert_allclose(scores[pos].cpu().numpy(), fwd.cpu().numpy(), **E_TOL,
                                       err_msg=f"E {arch}: retrieval against the forward")
        res["top100_equals_stable_sort"] = True
        res["seconds"] = time.perf_counter() - t_arch
        out["archs"][arch] = res
        log(f"[E] {arch} {res}")
        del model, cell, batch, user, cands, vals, ids, scores, fwd
    out["seconds"] = time.perf_counter() - t_all
    return out


def _smi(query: str) -> list[str]:
    """Lines of ``nvidia-smi --query-<query> --format=csv,noheader``."""
    return subprocess.run(["nvidia-smi", f"--query-{query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()


def _gpu_used_mib() -> float:
    """The card's device memory in use, all processes, in MiB."""
    return float(_smi("gpu=memory.used")[0].split()[0])


def _median(xs):
    import numpy as np

    return float(np.median(xs)) if len(xs) else None


def phase_q(dev, keep: dict) -> dict:
    """The continuous-batching scheduler on the card: phase A's K=4 engine
    with R's payloads behind ``Session``, first with one spawned process
    replica per shard (four workers on the one card, each rebuilt from the
    store), then inline.  A's 128 Boolean queries go in as single requests
    from 4 client threads (a tenant each), then R's 64 ranked (a) queries;
    every result is asserted equal to A's K=4 results and R's oracle, and
    nothing may be shed.  One traced run (worker spans in a lane per worker,
    kernel spans among them, nesting intact) and a crash check (a crashed
    replica respawned by the next batch, which is bit-identical) follow."""
    import shutil
    import tempfile
    import threading

    import numpy as np

    from repro_torch.obs import ProbeLog, Tracer, nesting_violations
    from repro_torch.serve import QueryRequest, Session
    from repro_torch.serve.sched.replica import ReplicaError

    q, want = keep["batch"], keep["results"][4]
    rq, oracle = keep["ranked"]
    eng = keep["engines"][4]
    rc = eng.cfg.ranked  # configuration (a), as phases R and S serve it
    rc.score_kernel, rc.fused_kernel, rc.topk_exhaustive_cutoff = True, False, 2048
    eng.cfg.sched.n_replicas = 1

    def submit_all(s, rows, **kw):
        """Each row one request, from 4 client threads (tenant = thread),
        all submitted before any is awaited -> (outcomes, wall seconds)."""
        outs = [None] * len(rows)
        t0 = time.perf_counter()

        def client(c):
            futs = [(i, s.submit_async(QueryRequest(terms=rows[i], tenant=f"client{c}", **kw)))
                    for i in range(c, len(rows), 4)]
            for i, f in futs:
                outs[i] = f.result(timeout=300)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        shed = [o for o in outs if o is None or not o.ok]
        if shed:
            raise AssertionError(f"{len(shed)} requests not served: {shed[:3]}")
        return outs, wall

    def check(outs, name):
        if len(outs) == len(want):
            bad = [i for i, (o, w) in enumerate(zip(outs, want)) if not np.array_equal(o.ids, w)]
        else:
            bad = [i for i, (o, w) in enumerate(zip(outs, oracle))
                   if not (np.array_equal(o.ids, w.ids) and np.array_equal(o.scores, w.scores))]
        if bad:
            raise AssertionError(f"Q {name}: {len(bad)} results differ, first {bad[:5]}")

    def served(s, label):
        eng.metrics.reset()
        s.slo.reset()
        outs, wall = submit_all(s, q)
        check(outs, f"{label} boolean")
        sched = eng.metrics.snapshot()["sched"]
        routs, rwall = submit_all(s, rq, mode="ranked", k=R_TOPK)
        check(routs, f"{label} ranked")
        slo = s.slo_report()
        auto = [o.autopsy() for o in outs]
        run = {
            "boolean_s": wall, "boolean_rps": len(q) / wall,
            "ranked_s": rwall, "ranked_rps": len(rq) / rwall,
            "batches": sched["batches"], "mean_batch": sched["batch_size"]["mean"],
            "autopsy_median_us": {k: _median([a[k] for a in auto]) for k in
                                  ("queue_us", "dispatch_us", "execute_us", "merge_us")},
            "slo_ms": {t: {"p50": v["p50_ms"], "p99": v["p99_ms"], "requests": v["requests"]}
                       for t, v in slo["tenants"].items()},
            "shed": eng.metrics.snapshot()["sched"].get("shed", {}),
        }
        log(f"[Q] {label}: {run}")
        return run

    t_phase = time.perf_counter()
    root = ROOT / "build"
    root.mkdir(parents=True, exist_ok=True)
    store = tempfile.mkdtemp(prefix="chip_smoke_sched_", dir=root)
    out: dict = {"phase": "Q", "docs": keep["inv"].n_docs, "shards": len(eng.shards),
                 "queries": int(len(q)), "ranked_queries": int(len(rq)), "clients": 4,
                 "max_batch": eng.cfg.sched.max_batch}
    try:
        t0 = time.perf_counter()
        s = Session(eng, store_dir=store)  # saves the store, builds the kernels
        out["store_s"] = time.perf_counter() - t0
        try:
            replicas = [r for g in s._groups for r in g.replicas]
            used0 = _gpu_used_mib()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=r.call, args=(("ping",),)) for r in replicas]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            out["spawn_all_s"] = time.perf_counter() - t0
            if not all(r.alive for r in replicas):
                raise AssertionError("a process replica did not come up")
            out["spawn_s"] = [dict(r.spawn_seconds) for r in replicas]
            t0 = time.perf_counter()
            s.warm()
            out["warm_s"] = time.perf_counter() - t0
            pids = [r.pid for r in replicas]
            # per process where the card's process list shows the workers'
            # pids (a container may hide them); else the card's memory in use
            # after the spawn and the warm batches, less before, per worker
            apps = [line.split(", ") for line in _smi("compute-apps=pid,used_memory")]
            out["worker_device_mib"] = {p: m for p, m in apps if int(p) in pids} or None
            out["device_mib_per_worker"] = (_gpu_used_mib() - used0) / len(replicas)
            out["r1"] = served(s, "R=1")

            # traced: worker spans in one pid lane per worker, kernel spans
            # among them, every lane's spans nested or disjoint
            tracer, plog = Tracer(), ProbeLog()
            eng.cfg.obs.trace, eng.cfg.obs.probe_log = tracer, plog
            try:
                submit_all(s, q[:32])
                submit_all(s, rq[:16], mode="ranked", k=R_TOPK)
            finally:
                eng.cfg.obs.trace = eng.cfg.obs.probe_log = None
            worker = [sp for sp in tracer.spans if sp.pid != 0]
            lanes = {sp.pid for sp in worker}
            if lanes != set(pids):
                raise AssertionError(f"worker lanes {sorted(lanes)} != worker pids {sorted(pids)}")
            bad = nesting_violations(tracer.spans, slack_us=0.5)
            if bad:
                raise AssertionError(f"{len(bad)} nesting violations, first {bad[:2]}")
            kspans: dict[str, int] = {}
            for sp in worker:
                if sp.name.startswith("kernel."):
                    kspans[sp.name] = kspans.get(sp.name, 0) + 1
            for name in ("kernel.membership", "kernel.bitset", "kernel.bm25_score"):
                if not kspans.get(name):
                    raise AssertionError(f"no {name} span in the worker lanes: {kspans}")
            out["trace"] = {"spans": len(tracer.spans), "worker_spans": len(worker),
                            "lanes": len(lanes), "kernel_spans": kspans,
                            "probe_records": plog.n_records, "nesting_violations": 0}

            # crash: the worker dies on the hook; the next batch respawns it
            # (spawn, CUDA context, rebuild, warm replay) and is exact
            rep = s._groups[0].replicas[0]
            pid0 = rep.pid
            try:
                rep.call(("crash",))
                raise AssertionError("the crash hook did not kill the worker")
            except ReplicaError:
                pass
            outs, wall = submit_all(s, q)
            check(outs, "after the crash")
            if rep.pid == pid0 or not rep.alive or not rep.warm_replays:
                raise AssertionError("the crashed replica was not respawned and warmed")
            out["crash"] = {"respawn_s": dict(rep.spawn_seconds),
                            "warm_replays": rep.warm_replays, "boolean_s": wall}
            log(f"[Q] crash: {out['crash']}")
        finally:
            s.close()
        eng.cfg.sched.n_replicas = 0
        with Session(eng) as s0:
            out["r0"] = served(s0, "R=0")
        out["r1_over_r0_boolean"] = out["r0"]["boolean_s"] / out["r1"]["boolean_s"]
    finally:
        shutil.rmtree(store, ignore_errors=True)
    out["exact"] = True
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def one_score_launch(topk, name: str, run: dict, eng) -> None:
    """In a package with ``rank.topk.topk_batch`` a multi-phase (a) batch
    scores its exhaustive items in one bm25_score launch per shard."""
    n = run["launches"]["bm25_score"]
    if hasattr(topk, "topk_batch") and not 0 < n <= len(eng.shards):
        raise AssertionError(f"{name}: {n} bm25_score launches on {len(eng.shards)} shards")


def block_step(algorithms, kernels: dict, keep: dict) -> dict:
    """Algorithm 3's whole candidate step on one of phase A's K=1 batches,
    beside its kernels' own times: its launches and the device memory it
    allocates in one call, then its time (CUDA events).  Launches made
    here are taken back off the counters.  A package whose block step is
    the fused ``block_candidates`` must make one masked membership launch,
    no dense one, and one bitset launch, and allocate less than a (Q*T,
    words) tensor."""
    import torch

    state, q = keep["state"], keep["queries"]
    saved = {n: k.launches for n, k in kernels.items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    algorithms.run_queries(state, q, "block")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launched = {n: k.launches - saved[n] for n, k in kernels.items()}
    ms = cuda_ms(lambda: algorithms.run_queries(state, q, "block"))
    for n, k in kernels.items():
        k.launches = saved[n]
    Q, T = q.shape
    words = -(-state.n_docs // 32)
    entry = "block_candidates" if hasattr(algorithms, "block_candidates") else "bitset_and_popcount"
    out = {"phase": "A_block", "entry": entry, "queries": int(Q), "T": int(T), "words": words,
           "block_query_ms": ms, "launches_per_call": {n: c for n, c in launched.items() if c},
           "allocated_bytes_per_call": peak, "qt_words_bytes": 4 * Q * T * words}
    log(f"[A] block step: {out}")
    want = {"membership_masked": 1, "membership": 0, "bitset": 1}
    if entry == "block_candidates" and (
            any(launched[n] != c for n, c in want.items()) or peak >= 4 * Q * T * words):
        raise AssertionError(f"Algorithm 3's block step is not {want} launches without a "
                             f"(Q*T, words) tensor: {out}")
    return out


def phase_d(dev, keep: dict) -> dict:
    """One list's whole decode through ``full_decode``: ITERS calls under
    torch.profiler for the device time of what each call issues, and ITERS
    more without it for the host time."""
    from collections import Counter

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.postings import search

    store = keep["engines"][1].shards[0].tier2
    terms = [t for t in range(store.n_terms)
             if int(store.lens[t]) and int(store.tags[t]) == search._OPTPFD_TAG]
    t = min(terms, key=lambda t: abs(int(store.lens[t]) - 100_000))

    def call():
        return search.full_decode(store, t, dev)

    if not np.array_equal(call(), store.postings(t)):
        raise AssertionError("full_decode differs from the host decoder")
    for _ in range(WARMUP):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            call()
        torch.cuda.synchronize()
    busy, names = {"kernel": 0.0, "copy": 0.0}, Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kind = "copy" if e.name.startswith(("Memcpy", "Memset")) else "kernel"
            busy[kind] += e.time_range.elapsed_us() / 1e3
            names[e.name[:60]] += 1
    t0 = time.perf_counter()
    for _ in range(ITERS):
        call()
    host_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    seen = bool(names)
    if not seen:
        log("[D] the profiler recorded no device activity; device time not measured")
    return {
        "phase": "D", "term": int(t), "values": int(store.lens[t]),
        "device_ms": (busy["kernel"] + busy["copy"]) / ITERS if seen else None,
        "kernel_ms": busy["kernel"] / ITERS if seen else None,
        "copy_ms": busy["copy"] / ITERS if seen else None,
        "device_ops_per_call": {n: c / ITERS for n, c in names.most_common()},
        "host_ms": host_ms,
    }


def probe_words(rows, terms) -> int:
    """Distinct packed correction words that guided_search probe rows read:
    a row's ranks cover the bits from r_lo*w to (r_lo+n)*w - 1 of its term's
    words, straddling words included."""
    import numpy as np

    from repro_torch.postings.search import union_size

    w = terms[rows[:, 0], 1].astype(np.int64)
    keep = (w > 0) & (rows[:, 3] > 0)
    base = terms[rows[keep, 0], 0].astype(np.int64)
    lo = rows[keep, 2].astype(np.int64) * w[keep]
    return union_size(base + lo // 32,
                      base + (lo + rows[keep, 3].astype(np.int64) * w[keep] - 1) // 32)


def phase_c(rec: Recorder, launch_counts: dict, keep: dict) -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.core.learned_bloom import NUMERIC_MARGIN
    from repro_torch.kernels.bitset.kernel import block_candidates
    from repro_torch.kernels.bitset.ref import block_candidates_ref
    from repro_torch.kernels.guided_search.kernel import probe_batch
    from repro_torch.kernels.guided_search.ref import probe_ref
    from repro_torch.kernels.membership.kernel import membership_bitmask
    from repro_torch.kernels.membership.ref import membership_bitmask_ref, membership_logits_ref
    from repro_torch.kernels.plm_decode.kernel import decode_batch
    from repro_torch.kernels.plm_decode.ref import decode_ref

    rows = []

    def row(name, replaces, fn, ref, err, bytes_, flops, library=None, extra=None,
            plain_in_graph=True, source=None):
        # ms, plain_ms, library_ms: device time (graph replay); the eager_*
        # keys time the same calls issued one by one from Python.  A plain
        # version whose shapes depend on the data (it reads a count back to
        # the host) cannot be captured: its plain_ms is then the eager time.
        b_bytes, b_ops = bytes_ / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
        plain_eager = cuda_ms(ref)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source or name}.cu",
            "replaces": replaces, "launches": launch_counts[name], "max_abs_err": err,
            "ms": graph_ms(fn), "plain_ms": graph_ms(ref) if plain_in_graph else plain_eager,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": graph_ms(library) if library is not None else None,
            "eager_ms": cuda_ms(fn), "plain_eager_ms": plain_eager,
            "plain_timing": "graph" if plain_in_graph else "eager",
            **(extra or {}),
        })
        log(f"[C] {rows[-1]}")

    # membership: bits may differ only where |logit - tau| <= NUMERIC_MARGIN (1 + |tau|)
    def membership_row(inputs, case):
        qe, de, tau, bias = inputs
        Q, E = qe.shape
        D = de.shape[0]
        got = membership_bitmask(qe, de, tau, bias)
        want = membership_bitmask_ref(qe, de, tau, bias)
        logits = membership_logits_ref(qe, de, bias)
        gap = (logits - tau[:, None]).abs()
        near = gap <= NUMERIC_MARGIN * (1 + tau.abs()[:, None])
        differ = bits_of(got ^ want, D)
        outside = int((differ & ~near).sum())
        if outside:
            raise AssertionError(f"membership ({case}): {outside} bits differ outside the margin")
        n_differ = int(differ.sum())
        err = float(gap[differ].max()) if n_differ else 0.0
        n_near = int(near.sum())
        del logits, gap, near, differ
        row("membership", "src/repro/kernels/membership/kernel.py:41",
            lambda: membership_bitmask(qe, de, tau, bias),
            lambda: membership_bitmask_ref(qe, de, tau, bias),
            err, 4 * (Q * E + D * E + Q + Q * got.shape[1]), 2 * Q * D * E,
            library=lambda: torch.matmul(qe, de.T),
            extra={"case": case, "shape": {"Q": Q, "D": D, "E": E},
                   "differing_bits": n_differ, "bits_within_margin": n_near,
                   "margin": NUMERIC_MARGIN})

    # rows 1 and 1b: the dense launch on the masked launch's inputs (A's K=1
    # block batch and the K=4 shard shape most of its launches saw); the path
    # launches the dense entry only in phase W, whose row (1c) leads the
    # kernels line
    largest, most = rec.inputs["membership_masked"], rec.second["membership_masked"][0]
    membership_row(largest, "largest")
    membership_row(most, "most_launched_shape")
    masked_row(largest, rec.kwargs["membership_masked"]["live"], row, "largest")
    masked_row(most, rec.second["membership_masked"][1]["live"], row, "most_launched_shape")

    args = rec.inputs["bitset"]
    got, want = block_candidates(*args), block_candidates_ref(*args)
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    if err:
        raise AssertionError("bitset (block_candidates) differs from its plain version")
    table, terms, slots, mrows, n_docs, block_size = args
    Qb, T = terms.shape
    Wb, words = table.shape[1], mrows.shape[1]
    n_valid = (terms >= 0).sum(dim=1)
    blk = torch.arange(words, device=terms.device) * 32 // block_size
    alive = ((got[1][:, blk // 32] >> (blk % 32).to(torch.int32)) & 1).bool()
    # membership rows are read only in the words of surviving blocks
    row_words = int((n_valid * alive.sum(dim=1)).sum())
    need = (4 * row_words + 4 * int(n_valid.sum()) * Wb + 8 * Qb * T
            + 4 * (Qb * words + Qb * Wb + Qb))
    row("bitset", "src/repro/kernels/bitset/kernel.py:49",
        lambda: block_candidates(*args), lambda: block_candidates_ref(*args),
        float(err), need, 0,
        extra={"entry": "block_candidates",
               "shape": {"Q": Qb, "T": T, "R": int(mrows.shape[0]), "words": words, "Wb": Wb,
                         "block_size": block_size, "row_words_read": row_words,
                         "row_words_all": int(mrows.shape[0]) * words}})

    args = rec.inputs["guided_search"]
    got, want = probe_batch(*args), probe_ref(*args)
    err = int((got - want).abs().max()) if got.numel() else 0
    if err:
        raise AssertionError("guided_search differs from its plain version")
    table, terms = args[0].cpu().numpy(), args[1].cpu().numpy()
    n_out, R = args[4], table.shape[0]
    words = probe_words(table, terms)
    n_seg, n_term = len(np.unique(table[:, 1])), len(np.unique(table[:, 0]))
    row("guided_search", "src/repro/kernels/guided_search/kernel.py:42",
        lambda: probe_batch(*args), lambda: probe_ref(*args),
        float(err), 4 * words + 24 * R + 8 * n_out + 12 * (n_seg + n_term), 0,
        plain_in_graph=False,
        extra={"shape": {"P": n_out, "rows": R, "chunk_rows": R - len(np.unique(table[:, 5])),
                         "window_ranks": int(table[:, 3].sum()), "words_touched": words,
                         "segments": n_seg, "terms": n_term}})

    def plm_row(tabs, case):
        got, want = decode_batch(*tabs), decode_ref(*tabs)
        if not torch.equal(got, want):
            raise AssertionError(f"plm_decode ({case}) differs from its plain version")
        S, L, n = tabs[0].shape[0], tabs[3].shape[0], tabs[5]
        words = tabs[4].numel()  # the lists' packed corrections, end to end
        row("plm_decode", "src/repro/kernels/plm_decode/kernel.py:48",
            lambda: decode_batch(*tabs), lambda: decode_ref(*tabs),
            0.0, 4 * words + 12 * S + 16 * L + 4 * n, 0,
            extra={"case": case, "shape": {"S": S, "lists": L, "N": n,
                                          "correction_words": words}})

    plm_row(rec.inputs["plm_decode"], "largest")
    plm_row(single_plm_list(rec.inputs["plm_decode"][0].device), "single_list")
    phase_c_ranked(rec, row, keep)
    dense_rows(rec, row)
    if "two_tier" in rec.inputs:  # phase S ran
        two_tier_row(rec.inputs["two_tier"], rec.kwargs["two_tier"], row, "largest")
        two_tier_row(*rec.second["two_tier"], row, "most_candidates")
    if "mlp_membership" in rec.second:  # phase M ran: its K=4 shard shapes
        mlp_row(rec.second["mlp_membership"][0], row, "most_launched_shape")
    if "mlp_membership_masked" in rec.second:
        mlp_masked_row(*rec.second["mlp_membership_masked"], row, "most_launched_shape")
    if "mlp_two_tier" in rec.second:
        mlp_two_tier_row(*rec.second["mlp_two_tier"], row, "most_candidates")
    return rows


def masked_row(inputs, live, row, case: str) -> None:
    """The masked membership launch (Algorithm 3's rows) on the live-block
    masks a block batch gave it: its words equal the dense launch's in the
    live words, word for word (the same arithmetic), and are zero in the
    others; outside the margin of tau they equal its plain version's.  The
    bound counts the live pairs' FMAs (2 operations each) and the bytes of
    the slot rows, the live docs' rows, the rows of words and the block
    words read; the library column is ``torch.matmul`` of every pair (fp32,
    logits only), as the dense row's."""
    import torch

    from repro_torch.core.learned_bloom import NUMERIC_MARGIN
    from repro_torch.kernels.membership.kernel import membership_bitmask
    from repro_torch.kernels.membership.ref import (live_words, membership_bitmask_ref,
                                                    membership_logits_ref)

    qe, de, tau, bias = inputs
    (S, E), D = qe.shape, de.shape[0]
    got = membership_bitmask(qe, de, tau, bias, live=live)
    alive = live_words(live, got.shape[1])
    dense = membership_bitmask(qe, de, tau, bias)
    if not torch.equal(got, torch.where(alive, dense, 0)):
        raise AssertionError(f"membership_masked ({case}): its live words differ from the dense "
                             f"launch's, or a dead word is not zero")
    want = membership_bitmask_ref(qe, de, tau, bias, live)
    logits = membership_logits_ref(qe, de, bias)
    gap = (logits - tau[:, None]).abs()
    near = gap <= NUMERIC_MARGIN * (1 + tau.abs()[:, None])
    differ = bits_of(got ^ want, D)
    outside = int((differ & ~near).sum())
    if outside:
        raise AssertionError(f"membership_masked ({case}): {outside} bits differ outside the "
                             f"margin")
    n_differ = int(differ.sum())
    err = float(gap[differ].max()) if n_differ else 0.0
    del logits, gap, near, differ, dense, want
    live_words_n = int(alive.sum())
    live_pairs = int(alive.repeat_interleave(32, dim=1)[:, :D].sum())
    live_docs = int(alive.any(dim=0).repeat_interleave(32)[:D].sum())
    table, terms = live.table, live.terms
    del alive
    row("membership_masked", "src/repro/kernels/membership/kernel.py:41",
        lambda: membership_bitmask(qe, de, tau, bias, live=live),
        lambda: membership_bitmask_ref(qe, de, tau, bias, live),
        err, 4 * (S * E + live_docs * E + S + S * got.shape[1]
                  + int((terms >= 0).sum()) * table.shape[1] + terms.numel() + S),
        2 * live_pairs * E, library=lambda: torch.matmul(qe, de.T), source="membership",
        extra={"case": case, "shape": {"S": S, "D": D, "E": E, "Q": int(terms.shape[0]),
                                       "T": int(terms.shape[1]),
                                       "block_size": live.block_size},
               "live_pairs": live_pairs, "all_pairs": S * D, "live_share": live_pairs / (S * D),
               "live_words": live_words_n, "live_docs": live_docs,
               "library": "torch.matmul, fp32, logits of every pair",
               "differing_bits": n_differ, "margin": NUMERIC_MARGIN})


GELU_OPS = 9  # x*x, *x, the fma (2), *sqrt(2/pi), tanh (as one), 1+, 0.5*x, the product


def mlp_pair_ops(dims) -> int:
    """fp32 operations per (slot, doc) pair of the MLP head: the halves'
    add and GELU per first-layer unit, each later layer's products (an FMA
    is two), bias adds and GELUs, and the final + bias."""
    ops = dims[0] * (1 + GELU_OPS)
    for i, (h_in, h_out) in enumerate(zip(dims[:-1], dims[1:])):
        ops += 2 * h_in * h_out + h_out + (GELU_OPS * h_out if i < len(dims) - 2 else 0)
    return ops + 1


def mlp_row(inputs, row, case: str) -> None:
    """mlp_membership against its plain version: every logit the kernel
    computes within NUMERIC_MARGIN (1 + |logit|) of the plain version's,
    and the bits equal except for pairs whose logit lies within the margin
    of tau (counted).  The bound is operations (``mlp_pair_ops`` a pair
    over the card's fp32 rate, bytes far below); the library time is the
    same logits through PyTorch calls (``F.gelu`` of the broadcast halves,
    ``torch.matmul`` by the last layer) over the plain version's doc tiles."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.learned_bloom import NUMERIC_MARGIN
    from repro_torch.kernels.mlp_membership.kernel import mlp_membership
    from repro_torch.kernels.mlp_membership.ref import (doc_tile, mlp_logits_ref,
                                                        mlp_membership_ref)

    a, bd, later, dims, tau, bias = inputs
    (S, H1), D = a.shape, bd.shape[0]
    tile = doc_tile(S, H1)
    got = mlp_membership(*inputs)
    want = mlp_membership_ref(*inputs)
    kernel_logits = torch.empty((S, D), dtype=torch.float32, device=a.device)
    if not torch.equal(mlp_membership(*inputs, logits=kernel_logits), got):
        raise AssertionError(f"mlp_membership ({case}): two launches differ")
    logits = torch.cat([mlp_logits_ref(a, bd[d0: d0 + tile], later, dims, bias)
                        for d0 in range(0, D, tile)], dim=1)
    lerr = (kernel_logits - logits).abs()
    far = int((lerr > NUMERIC_MARGIN * (1 + logits.abs())).sum())
    if far:
        raise AssertionError(f"mlp_membership ({case}): {far} logits differ by more than the "
                             f"margin")
    near = (logits - tau[:, None]).abs() <= NUMERIC_MARGIN * (1 + tau.abs()[:, None])
    differ = bits_of(got ^ want, D)
    outside = int((differ & ~near).sum())
    if outside:
        raise AssertionError(f"mlp_membership ({case}): {outside} bits differ outside the margin")
    n_differ, n_near, err = int(differ.sum()), int(near.sum()), float(lerr.max())
    hits = int(bits_of(got, D).sum())
    del kernel_logits, logits, lerr, near, differ
    library = None
    if len(dims) == 2:  # one hidden layer: its last layer is one product
        w2 = later[:H1].view(H1, 1)

        def library():
            for d0 in range(0, D, tile):
                torch.matmul(F.gelu(a[:, None, :] + bd[None, d0: d0 + tile], approximate="tanh"),
                             w2)
    row("mlp_membership", "src/repro/core/membership.py:66",
        lambda: mlp_membership(*inputs), lambda: mlp_membership_ref(*inputs),
        err, 4 * (S * H1 + D * H1 + later.numel() + S + S * got.shape[1]),
        mlp_pair_ops(dims) * S * D, library=library,
        extra={"case": case, "shape": {"S": S, "D": D, "dims": list(dims)},
               "ops_per_pair": mlp_pair_ops(dims), "logit_tolerance": "margin (1 + |logit|)",
               "differing_bits": n_differ, "bits_within_margin": n_near, "hits": hits,
               "margin": NUMERIC_MARGIN})


def mlp_plain_logits(a, bd, later, dims, bias):
    """(S, D) plain logits of every pair, over the plain version's doc tiles."""
    import torch

    from repro_torch.kernels.mlp_membership.ref import doc_tile, mlp_logits_ref

    tile = doc_tile(*a.shape)
    return torch.cat([mlp_logits_ref(a, bd[d0: d0 + tile], later, dims, bias)
                      for d0 in range(0, bd.shape[0], tile)], dim=1)


def mlp_masked_row(args, kw, row, case: str) -> None:
    """The masked mlp_membership (Algorithm 3's rows) on the live-block
    masks phase M gave it, against its plain version: every live pair
    scored, every scored logit within NUMERIC_MARGIN (1 + |logit|) of the
    plain one, the bits equal outside the margin of tau (dead words zero in
    both).  The bound counts the live pairs only (``mlp_pair_ops`` each) and
    the bytes of the live docs' rows; no one PyTorch call computes it."""
    import torch

    from repro_torch.core.learned_bloom import NUMERIC_MARGIN
    from repro_torch.kernels.mlp_membership.kernel import mlp_membership
    from repro_torch.kernels.mlp_membership.ref import live_words, mlp_membership_ref

    a, bd, later, dims, tau, bias = args
    live = kw["live"]
    (S, H1), D = a.shape, bd.shape[0]
    got = mlp_membership(*args, live=live)
    want = mlp_membership_ref(*args, live)
    kernel_logits = torch.full((S, D), float("nan"), device=a.device)
    if not torch.equal(mlp_membership(*args, live=live, logits=kernel_logits), got):
        raise AssertionError(f"mlp_membership_masked ({case}): two launches differ")
    alive = live_words(live, got.shape[1]).repeat_interleave(32, dim=1)[:, :D]
    scored = ~torch.isnan(kernel_logits)
    if bool((alive & ~scored).any()):
        raise AssertionError(f"mlp_membership_masked ({case}): a live pair was not scored")
    logits = mlp_plain_logits(a, bd, later, dims, bias)
    lerr = torch.where(scored, (kernel_logits - logits).abs(), 0.0)
    if bool((lerr > NUMERIC_MARGIN * (1 + logits.abs())).any()):
        raise AssertionError(f"mlp_membership_masked ({case}): logits differ by more than the "
                             f"margin")
    near = (logits - tau[:, None]).abs() <= NUMERIC_MARGIN * (1 + tau.abs()[:, None])
    differ = bits_of(got ^ want, D)
    outside = int((differ & ~near).sum())
    if outside:
        raise AssertionError(f"mlp_membership_masked ({case}): {outside} bits differ outside "
                             f"the margin")
    live_pairs, n_scored = int(alive.sum()), int(scored.sum())
    live_docs = int(alive.any(dim=0).sum())
    n_differ, err = int(differ.sum()), float(lerr.max())
    table, terms = live.table, live.terms
    del kernel_logits, logits, lerr, near, differ, alive, scored
    row("mlp_membership_masked", "src/repro/core/algorithms.py:155",
        lambda: mlp_membership(*args, live=live), lambda: mlp_membership_ref(*args, live),
        err, 4 * (S * H1 + live_docs * H1 + later.numel() + 2 * S + S * got.shape[1]
                  + int((terms >= 0).sum()) * table.shape[1] + terms.numel()),
        mlp_pair_ops(dims) * live_pairs, source="mlp_membership",
        extra={"case": case, "shape": {"S": S, "D": D, "dims": list(dims),
                                       "Q": int(terms.shape[0]), "T": int(terms.shape[1]),
                                       "block_size": live.block_size},
               "live_pairs": live_pairs, "all_pairs": S * D, "live_share": live_pairs / (S * D),
               "scored_pairs": n_scored, "live_docs": live_docs,
               "ops_per_pair": mlp_pair_ops(dims), "logit_tolerance": "margin (1 + |logit|)",
               "differing_bits": n_differ, "margin": NUMERIC_MARGIN})


def mlp_two_tier_row(args, kw, row, case: str) -> None:
    """mlp_two_tier (Algorithm 2 with a head) on the batch of phase M with
    the most candidates, against its plain version (bits equal outside the
    margin of tau for some valid slot of the query) and against the dense
    launch's rows ANDed over each query's slots and with the tier-1 union
    (the same arithmetic: equal words).  The bound counts the union's
    (doc, slot) products (``mlp_pair_ops`` each) and the bytes of the
    union's doc rows, the list entries, the slots' rows and the bitmap."""
    import torch

    from repro_torch.core.learned_bloom import NUMERIC_MARGIN
    from repro_torch.kernels.membership.ref import pack_bool_words
    from repro_torch.kernels.mlp_membership.kernel import mlp_membership, mlp_two_tier
    from repro_torch.kernels.mlp_membership.ref import mlp_two_tier_ref
    from repro_torch.kernels.two_tier.ref import tier1_union

    tier1, tier1_len, queries, slots, a, bd, later, dims, tau, bias = args
    got = mlp_two_tier(*args, **kw)
    want = mlp_two_tier_ref(*args)
    (S, H1), D = a.shape, bd.shape[0]
    Q, T = queries.shape
    union = tier1_union(tier1, tier1_len, queries, D)
    rows = torch.cat([mlp_membership(a, bd, later, dims, tau, bias),
                      torch.full((1, got.shape[1]), -1, dtype=torch.int32, device=a.device)])
    picked = rows[torch.where(slots >= 0, slots, S).long()]  # (Q, T, words)
    dense = picked[:, 0].clone()
    for t in range(1, T):
        dense &= picked[:, t]
    valid = queries >= 0
    dense = torch.where(valid.any(dim=1, keepdim=True), dense & pack_bool_words(union), 0)
    if not torch.equal(got, dense):
        raise AssertionError(f"mlp_two_tier ({case}): {int((got != dense).sum())} words differ "
                             f"from the dense rows ANDed with the union")
    del rows, picked, dense
    logits = mlp_plain_logits(a, bd, later, dims, bias)
    qi, di = bits_of(got ^ want, D).nonzero(as_tuple=True)
    err = 0.0
    if len(qi):  # each differing bit: its nearest valid slot's |logit - tau|
        gap = torch.full((len(qi),), float("inf"), device=a.device)
        rel = torch.full((len(qi),), float("inf"), device=a.device)
        for t in range(T):
            r = slots[qi, t].long()
            g = (logits[r.clamp(min=0), di] - tau[r.clamp(min=0)]).abs()
            g = torch.where(r >= 0, g, float("inf"))
            rel = torch.minimum(rel, g / (1 + tau[r.clamp(min=0)].abs()))
            gap = torch.minimum(gap, g)
        if bool((rel > NUMERIC_MARGIN).any()):
            raise AssertionError(f"mlp_two_tier ({case}): {int((rel > NUMERIC_MARGIN).sum())} "
                                 f"bits differ outside the margin")
        err = float(gap.max())
    del logits
    n_valid = valid.sum(dim=1)
    pairs = int((union.sum(dim=1) * n_valid).sum())
    entries = int(tier1_len[queries[valid].long()].sum())
    docs = int(union.any(dim=0).sum())
    need = 4 * (2 * Q * T + S * H1 + 2 * S + entries + docs * H1 + later.numel() + got.numel())
    row("mlp_two_tier", "src/repro/core/algorithms.py:112",
        lambda: mlp_two_tier(*args, **kw), lambda: mlp_two_tier_ref(*args),
        err, need, mlp_pair_ops(dims) * pairs, plain_in_graph=False, source="mlp_membership",
        extra={"case": case, "differing_bits": len(qi), "margin": NUMERIC_MARGIN,
               "ops_per_pair": mlp_pair_ops(dims),
               "shape": {"Q": Q, "T": T, "valid_slots": int(n_valid.sum()),
                         "k": int(tier1.shape[1]), "D": D, "dims": list(dims),
                         "list_entries": entries, "union_docs": int(union.sum()),
                         "distinct_docs": docs, "pairs": pairs}})


def candidate_total(args) -> int:
    """A Recorder measure of a two_tier call: the positions of its queries'
    valid tier-1 lists, summed over the batch."""
    import torch

    tier1_len, queries = args[1], args[2]
    lens = torch.where(queries >= 0, tier1_len[queries.clamp(min=0).long()], 0)
    return int(lens.sum())


def two_tier_row(args, kw, row, case: str) -> None:
    """two_tier against its plain version, the bits allowed to differ only
    where a valid term's logit lies within the margin of its tau.  The bound
    counts what these inputs need: the (Q, T) ids, the valid slots' tau,
    lengths and term rows, their tier-1 entries, the doc row of every doc
    in some query's union (read once), the bitmap written; and 2 E FLOPs
    per (union doc, valid slot) of each query."""
    import torch

    from repro_torch.core.learned_bloom import NUMERIC_MARGIN
    from repro_torch.kernels.two_tier.kernel import two_tier_candidates
    from repro_torch.kernels.two_tier.ref import tier1_union, two_tier_ref

    tier1, tier1_len, queries, te, de, tau, bias = args
    got = two_tier_candidates(*args, **kw)
    want = two_tier_ref(*args)
    D, E = de.shape
    Q, T = queries.shape
    differ = bits_of(got ^ want, D)
    qi, di = differ.nonzero(as_tuple=True)
    err = 0.0
    if len(qi):  # each differing bit: its nearest valid term's |logit - tau|
        qs = queries.long()
        gap = torch.full((len(qi),), float("inf"), device=de.device)
        rel = torch.full((len(qi),), float("inf"), device=de.device)
        for t in range(T):
            ts = qs[qi, t].clamp(min=0)
            g = ((te[ts] * de[di]).sum(-1) + bias - tau[ts]).abs()
            g = torch.where(qs[qi, t] >= 0, g, float("inf"))
            rel = torch.minimum(rel, g / (1 + tau[ts].abs()))
            gap = torch.minimum(gap, g)
        if bool((rel > NUMERIC_MARGIN).any()):
            raise AssertionError(f"two_tier ({case}): {int((rel > NUMERIC_MARGIN).sum())} "
                                 f"bits differ outside the margin")
        err = float(gap.max())
    union = tier1_union(tier1, tier1_len, queries, D)
    valid = queries >= 0
    n_valid = valid.sum(dim=1)
    pairs = int((union.sum(dim=1) * n_valid).sum())
    terms = queries[valid].long()
    lens = int(tier1_len[terms].sum())
    docs = int(union.any(dim=0).sum())
    need = (4 * Q * T + 8 * int(n_valid.sum()) + 4 * E * int(terms.unique().numel())
            + 4 * lens + 4 * E * docs + 4 * got.numel())
    row("two_tier", "src/repro/core/algorithms.py:97",
        lambda: two_tier_candidates(*args, **kw), lambda: two_tier_ref(*args),
        err, need, 2 * E * pairs, plain_in_graph=False,
        extra={"case": case, "differing_bits": int(differ.sum()), "margin": NUMERIC_MARGIN,
               "shape": {"Q": Q, "T": T, "valid_slots": int(n_valid.sum()),
                         "k": int(tier1.shape[1]), "D": D, "E": E,
                         "list_entries": lens, "union_docs": int(union.sum()),
                         "distinct_docs": docs, "pairs": pairs}})


def single_pfor_list(keep: dict, dev):
    """Phase A's optpfd list (K=1 shard) with the length closest to 100,000
    ids, staged as the main path stages a batch -> (words, meta, n)."""
    from repro_torch.kernels.pfor.ops import stage_batch
    from repro_torch.postings.search import decode_kernel

    store = keep["engines"][1].shards[0].tier2
    terms = [t for t in range(store.n_terms) if decode_kernel(store, t) == "pfor"]
    t = min(terms, key=lambda t: abs(int(store.lens[t]) - 100_000))
    n = int(store.lens[t])
    words, meta, _, _ = stage_batch([store.streams[t][1:]], [n], device=dev)
    return words, meta, n


def single_plm_list(dev):
    """One smooth list of 100,000 ids in phase B's universe (seed B_SEED),
    PLM-coded, staged as the main path stages a batch."""
    import numpy as np

    from repro_torch.kernels.plm_decode.ops import stage_batch
    from repro_torch.postings.plm import plm_encode

    rng = np.random.default_rng(B_SEED)
    ids = np.unique(_smooth_list(rng, 100_000, B_UNIVERSE))
    return stage_batch([plm_encode(ids)], [len(ids)], device=dev)[0]


def phase_c_ranked(rec: Recorder, row, keep: dict) -> None:
    """Phase C rows of pfor and the two kernels of the ranked slice; the
    bounds count what this run's inputs need: true blocks, true T, true
    lanes."""
    import torch

    from repro_torch.kernels.bm25_score.kernel import score_batch
    from repro_torch.kernels.bm25_score.ref import score_ref
    from repro_torch.kernels.fused_query.kernel import fused_topk
    from repro_torch.kernels.fused_query.ref import NEVER, fused_topk_ref
    from repro_torch.kernels.pfor.kernel import pfor_decode
    from repro_torch.kernels.pfor.ref import pfor_decode_ref

    def pfor_row(words, meta, n_out, case):
        got, want = pfor_decode(words, meta, n_out), pfor_decode_ref(words, meta, n_out)
        if not torch.equal(got, want):
            raise AssertionError(f"pfor ({case}) differs from its plain version")
        if int(got[-1]):
            raise AssertionError(f"pfor ({case}): the overflow flag is up")
        m = meta.long()
        packed = int(((m[:, 2] * m[:, 0] + 31) // 32).sum())
        n_exc = int(m[:, 5].sum())
        row("pfor", "src/repro/kernels/pfor/kernel.py:47",
            lambda: pfor_decode(words, meta, n_out), lambda: pfor_decode_ref(words, meta, n_out),
            # 7 of the 8 meta columns: the last pads a row to 32 bytes
            0.0, 4 * (packed + 2 * n_exc) + 4 * 7 * meta.shape[0] + 4 * (n_out + 1), 0,
            extra={"case": case,
                   "shape": {"lists": int(m[:, 6].sum()), "blocks": int(meta.shape[0]),
                             "values": n_out, "packed_words": packed, "exceptions": n_exc}},
            plain_in_graph=False)

    pfor_row(*rec.inputs["pfor"], "largest")
    pfor_row(*single_pfor_list(keep, rec.inputs["pfor"][0].device), "single_list")

    imp, scale = rec.inputs["bm25_score"]
    (gi, gf), (wi, wf) = score_batch(imp, scale), score_ref(imp, scale)
    if not (torch.equal(gi, wi) and torch.equal(gf, wf)):
        raise AssertionError("bm25_score differs from its plain version")
    P, T = imp.shape
    # the same window one int32 off a 16-byte edge: the kernel's 4-byte loads
    flat = torch.empty(P * T + 1, dtype=imp.dtype, device=imp.device)
    skew = flat[1:].view(P, T)
    skew.copy_(imp)
    row("bm25_score", "src/repro/kernels/bm25_score/kernel.py:37",
        lambda: score_batch(imp, scale), lambda: score_ref(imp, scale),
        0.0, 4 * P * T + 8 * P, 0, library=lambda: imp.sum(1),
        extra={"shape": {"P": P, "T": T},
               "scalar_load_ms": graph_ms(lambda: score_batch(skew, scale))})

    def fused_row(tiles, kw, case):
        (gi, gs), (wi, ws) = fused_topk(*tiles, **kw), fused_topk_ref(*tiles, **kw)
        if not (torch.equal(gi, wi) and torch.equal(gs, ws)):
            raise AssertionError(f"fused_topk ({case}) differs from its plain version")
        wlen, cand = tiles[3], tiles[11]
        Q, T, C = wlen.shape
        W = tiles[7].shape[3]
        lanes = wlen.clamp(0, W).long()
        real = cand != NEVER  # (Q, C) true candidates
        live_slot = (lanes > 0).any(dim=2)  # (Q, T)
        slot_no = torch.arange(1, T + 1, device=wlen.device)
        t_true = (live_slot.long() * slot_no).max(dim=1).values  # true T per row
        rows_true = int(real.any(dim=1).sum())
        cells = int((t_true * real.sum(dim=1)).sum())  # (q, t, c) wlen reads
        n_lanes = int(lanes.sum())
        need = (4 * cells + 16 * int((lanes > 0).sum()) + 16 * n_lanes + 8 * int(t_true.sum())
                + 8 * int(real.sum()) + rows_true * (4 + 8 * kw["k"]))
        row("fused_topk", "src/repro/kernels/fused_query/kernel.py:96",
            lambda: fused_topk(*tiles, **kw), lambda: fused_topk_ref(*tiles, **kw),
            0.0, need, 0,
            extra={"case": case,
                   "shape": {"Q": Q, "T": T, "C": C, "W": W, "k": kw["k"],
                             "true_rows": rows_true, "true_candidates": int(real.sum()),
                             "true_cells": cells, "lanes": n_lanes}})

    fused_row(rec.inputs["fused_topk"], rec.kwargs["fused_topk"], "largest")
    fused_row(*rec.second["fused_topk"], "most_true_candidates")


def dense_rows(rec: Recorder, row) -> None:
    """Phase C rows of dense_topk against its plain version (the PyTorch
    peel loop the port ran before the kernel): on the largest batch phase R
    gave it, and on a synthetic arena at the caps (131,072 docs, 511 terms,
    a 64-query batch of 2 to 8 terms, k = 10 and 32).  Ids, scores and
    rounds must be equal.  The bound counts the table rows the true (non-pad)
    slots gather, read once, the (Q, T) ids, the floors and the outputs."""
    import numpy as np
    import torch

    from repro_torch.kernels.fused_query import ref
    from repro_torch.kernels.fused_query.dense import dense_impl

    if not hasattr(ref, "dense_ref"):  # a package whose dense pass is PyTorch operations
        return
    from repro_torch.kernels import autotune
    from repro_torch.kernels.fused_query.ref import dense_ref

    def one(table, qt, floors, k, case):
        got, want = dense_impl(table, qt, floors, k=k), dense_ref(table, qt, floors, k=k)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"dense_topk ({case}) differs from its plain version")
        Q, T = qt.shape
        slots = int((qt >= 0).sum())
        need = slots * table.shape[1] * table.element_size() + 4 * Q * T + 4 * Q + 8 * Q * k + 8
        row("dense_topk", "src/repro/kernels/fused_query/dense.py:67 (XLA, not Pallas)",
            lambda: dense_impl(table, qt, floors, k=k), lambda: dense_ref(table, qt, floors, k=k),
            0.0, need, 0,
            extra={"case": case, "shape": {"Q": Q, "T": T, "docs": int(table.shape[1]),
                                          "terms": int(table.shape[0] - 1), "true_slots": slots,
                                          "k": k, "rounds": int(got[2]),
                                          "hits": int((got[1] > 0).sum())}})

    table, qt, floors = rec.inputs["dense_topk"]
    one(table, qt, floors, rec.kwargs["dense_topk"]["k"], "phase_r")
    dev = table.device
    arena = autotune._synthetic_arena(1 << 17, 511, 2048, seed=R_SEED, device=dev)
    batch = autotune._workload(511, (64,), 8, seed=R_SEED + 1)[0]
    qt = np.full((64, 8), -1, np.int32)
    for i, ts in enumerate(batch):
        qt[i, : len(ts)] = ts
    qt = torch.from_numpy(qt).to(dev)
    floors = torch.zeros(64, dtype=torch.int32, device=dev)
    for k in (10, 32):
        one(arena.table, qt, floors, k, f"cap_k{k}")


# ------------------------------------------------------------ phase W
W_SEED = 41
W_LIB_CHUNKS = 4  # torch.matmul's row-1c logits in doc chunks (25.7 GB whole)
W_QUERIES = 256  # one rank's share of serve_queries' 4,096 (the 16-way data axis)
W_BLOCK_QUERIES = 64  # one rank's share of serve_block's 1,024
W_CHECK_DOCS = 65_536  # the plain versions' first docs
W_CHECK_SHARE = 0.01  # and this share of the words, drawn at random
W_CHECK_CHUNK = 2 ** 17  # docs a chunk of row 1c's check on every doc (1 GiB of logits)


def _w_plain_words(te, de_rows, tau, valid):
    """Plain versions of exhaustive_step's words on a subset of docs: the
    membership rows of the valid slots (``membership_bitmask_ref``, true fp32)
    ANDed over each query's terms (``bitset_and_popcount_ref``), and the
    bits whose logit lies within NUMERIC_MARGIN (1 + |tau|) of tau for some
    valid term of the query (there the kernel's fp32 order may differ)."""
    import torch

    from repro_torch.core.learned_bloom import NUMERIC_MARGIN
    from repro_torch.kernels.bitset.ref import bitset_and_popcount_ref
    from repro_torch.kernels.membership.ref import (membership_bitmask_ref,
                                                    membership_logits_ref, pack_bool_words)

    q, t = valid.shape
    rows = membership_bitmask_ref(te, de_rows, tau, 0.0)  # (R, words)
    logits = membership_logits_ref(te, de_rows, 0.0)
    near_rows = pack_bool_words((logits - tau[:, None]).abs()
                                <= NUMERIC_MARGIN * (1 + tau.abs()[:, None]))
    del logits
    slot = torch.cumsum(valid.reshape(-1).long(), 0).reshape(q, t) - 1
    full = torch.full((q, t, rows.shape[1]), -1, dtype=torch.int32, device=rows.device)
    full[valid] = rows[slot[valid]]
    words, _ = bitset_and_popcount_ref(full, valid.to(torch.int32))
    full.zero_()
    full[valid] = near_rows[slot[valid]]
    near = full[:, 0]
    for i in range(1, t):
        near = near | full[:, i]
    return words, near


def _profiled_ms(profile: dict | None, kernel: str) -> float | None:
    """Device ms of the named kernel in a ``_device_breakdown`` profile;
    None where the profiler saw no device activity."""
    if profile is None:
        return None
    hits = [k["ms"] for k in profile["top"] if f"{kernel}_kernel" in k["kernel"]]
    if len(hits) != 1:
        raise AssertionError(f"{kernel}: {len(hits)} profile rows in {profile['top']}")
    return hits[0]


def _w_membership_row(te, de, tau, step_ms: float) -> dict:
    """Row 1c, the kernels line's ``membership`` row: the dense launch as
    ``exhaustive_step`` makes it (the valid slots' rows, the bf16 doc table
    read in place).  Its words against the plain version on every doc, in
    W_CHECK_CHUNK doc chunks (outside NUMERIC_MARGIN (1 + |tau|) of tau
    they must agree), and against the launch on the table widened to fp32,
    word for word (the widening is exact).  ``ms`` is the kernel's device
    time in the step's profile (``step_ms``; where the profiler saw nothing,
    ``eager_ms``) and ``eager_ms`` CUDA events over three calls one by one
    (the launch gaps are below 0.1% of a 37 ms call); the plain version and ``torch.matmul`` of
    the same product in fp32 (logits only) run in W_LIB_CHUNKS doc chunks
    of the widened table (25.7 GB of logits whole).  The bound: the slot
    rows, the bf16 table, the thresholds and the words moved once, 2 S D E
    operations.  These launches are no part of the path's count."""
    import torch

    from repro_torch.core.learned_bloom import NUMERIC_MARGIN
    from repro_torch.kernels.membership.kernel import KERNEL as MEMBERSHIP, membership_bitmask
    from repro_torch.kernels.membership.ref import (membership_bitmask_ref,
                                                    membership_logits_ref, pack_bool_words)

    counted = MEMBERSHIP.launches
    (S, E), D = te.shape, de.shape[0]
    got = membership_bitmask(te, de, tau, 0.0)
    n_differ = n_near = 0
    err = 0.0
    for c0 in range(0, D, W_CHECK_CHUNK):
        logits = membership_logits_ref(te, de[c0:c0 + W_CHECK_CHUNK], 0.0)
        gap = (logits - tau[:, None]).abs()
        near = gap <= NUMERIC_MARGIN * (1 + tau.abs()[:, None])
        want = pack_bool_words(logits >= tau[:, None])
        differ = bits_of(got[:, c0 // 32:c0 // 32 + want.shape[1]] ^ want, logits.shape[1])
        outside = int((differ & ~near).sum())
        if outside:
            raise AssertionError(f"W membership: {outside} bits differ outside the margin "
                                 f"in docs {c0}..")
        n_differ += int(differ.sum())
        n_near += int(near.sum())
        if differ.any():
            err = max(err, float(gap[differ].max()))
        del logits, gap, near, want, differ
    de32 = de.float()
    if not torch.equal(got, membership_bitmask(te, de32, tau, 0.0)):
        raise AssertionError("W membership: the bf16 table's words differ from the widened "
                             "fp32 table's")
    eager_ms, _ = _event_ms(lambda: membership_bitmask(te, de, tau, 0.0), 1, 3)
    MEMBERSHIP.launches = counted
    chunks = de32.split(-(-D // W_LIB_CHUNKS))
    library_ms, _ = _event_ms(lambda: [tuple((te @ c.T).shape) for c in chunks], 1, 3)
    plain_ms, _ = _event_ms(lambda: [tuple(membership_bitmask_ref(te, c, tau, 0.0).shape)
                                     for c in chunks], 0, 1)
    del de32, chunks
    b_bytes = (4 * S * E + 2 * D * E + 4 * S + 4 * S * got.shape[1]) / HBM_BYTES_PER_S * 1e3
    b_ops = 2 * S * D * E / FP32_FLOPS * 1e3
    return {"name": "membership", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/membership.cu",
            "replaces": "src/repro/kernels/membership/kernel.py:41", "max_abs_err": err,
            "ms": eager_ms if step_ms is None else step_ms, "plain_ms": plain_ms,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations", "library_ms": library_ms,
            "eager_ms": eager_ms, "plain_eager_ms": plain_ms, "plain_timing": "eager",
            "case": "W_exhaustive_step",
            "shape": {"Q": S, "D": D, "E": E, "doc_dtype": str(de.dtype).split(".")[-1]},
            "timing": ("ms: eager_ms, the profiler saw no device time" if step_ms is None
                       else "ms: torch.profiler device time in one step")
                      + f"; eager_ms, plain_ms, library_ms: CUDA events, the last two in "
                        f"{W_LIB_CHUNKS} doc chunks",
            "library": "torch.matmul, fp32, logits only", "differing_bits": n_differ,
            "bits_within_margin": n_near, "margin": NUMERIC_MARGIN,
            "bf16_words_equal_fp32": True}


def phase_w(dev) -> dict:
    """Phase W: one rank's share of the paper's system at ClueWeb09B scale
    on the (16, 16) mesh (``launch/dryrun_learned_index``), on the
    membership and bitset kernels."""
    import numpy as np
    import torch

    from repro_torch.launch import dryrun_learned_index as li

    t0 = time.perf_counter()
    plan = {r["shape"]: r for r in li.run(multi_pod=False)}
    exh, blk = plan["serve_queries"]["args"], plan["serve_block"]["args"]
    n_docs, e = exh["doc_embed"]["shard_shape"]
    n_terms = exh["term_embed"]["shard_shape"][0]
    q_exh, t = exh["queries"]["shard_shape"]
    if q_exh != W_QUERIES or blk["queries"]["shard_shape"][0] != W_BLOCK_QUERIES:
        raise AssertionError(f"the plan's per-rank queries {q_exh}, "
                             f"{blk['queries']['shard_shape'][0]}")
    gen = torch.Generator(device=dev).manual_seed(W_SEED)
    _free()
    # the rank's shard: doc rows of the data axis, term rows of the model axis;
    # f = te . de ~ N(0, 1), tau in [0.3, 0.8): a term holds ~30% of the docs
    params = {
        "doc_embed": torch.randn((n_docs, e), generator=gen, device=dev).to(torch.bfloat16),
        "term_embed": (torch.randn((n_terms, e), generator=gen, device=dev)
                       / np.sqrt(e)).to(torch.bfloat16),
        "tau": 0.3 + 0.5 * torch.rand(n_terms, generator=gen, device=dev),
    }
    queries = torch.randint(0, n_terms, (q_exh, t), generator=gen, device=dev, dtype=torch.int32)
    queries[-1, t - 3:] = -1  # pad terms act as all-ones
    allocated = {**params, "queries": queries}
    bytes_ok = {n: allocated[n].numel() * allocated[n].element_size() == exh[n]["bytes"]
                for n in exh}
    seconds = {"setup": time.perf_counter() - t0}

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    first_ms, words = _event_ms(lambda: li.exhaustive_step(params, queries), 0, 1)
    peak = torch.cuda.max_memory_allocated()
    ms, _ = _event_ms(lambda: li.exhaustive_step(params, queries), 0, 3)
    _, profile = _device_breakdown(lambda: li.exhaustive_step(params, queries), top=6)
    n_words = words.shape[1]
    if tuple(words.shape) != (q_exh, n_docs // 32):
        raise AssertionError(f"exhaustive_step words {tuple(words.shape)}")

    # the plain versions: the first docs, and a random share of the words
    t1 = time.perf_counter()
    valid = queries >= 0
    q = queries.clamp(min=0).long()
    te = params["term_embed"][q[valid]].float()
    tau = params["tau"][q[valid]]
    checks = {}
    cols = torch.randperm(n_words, generator=gen, device=dev)[:int(n_words * W_CHECK_SHARE)]
    cols = cols.sort().values
    for name, wcols in (("first_docs", torch.arange(W_CHECK_DOCS // 32, device=dev)),
                        ("random_words", cols)):
        doc = (wcols[:, None] * 32 + torch.arange(32, device=dev)).reshape(-1)
        want, near = _w_plain_words(te, params["doc_embed"][doc].float(), tau, valid)
        got = words[:, wcols]
        differ = int(_popcount((got ^ want) & ~near))
        if differ:
            raise AssertionError(f"W ({name}): {differ} bits differ outside the margin")
        checks[name] = {"words": int(want.numel()), "bits_within_margin": int(_popcount(near)),
                        "differing_bits_within_margin": int(_popcount((got ^ want) & near)),
                        "hits": int(_popcount(got))}
    seconds["plain_checks"] = time.perf_counter() - t1
    membership = _w_membership_row(te.contiguous(), params["doc_embed"],
                                   tau.float().contiguous(), _profiled_ms(profile, "membership"))
    seconds["membership_row"] = time.perf_counter() - t1 - seconds["plain_checks"]
    hits = int(_popcount(words))
    flop = 2 * int(valid.sum()) * n_docs * e
    bound = {"ops_ms": flop / FP32_FLOPS * 1e3,
             "bytes_ms": (n_docs * e * 2 + int(valid.sum()) * n_words * 4) / HBM_BYTES_PER_S * 1e3}

    # serve_block: the first W_BLOCK_QUERIES queries, 64 candidate blocks each
    nb = blk["block_maps"]["shard_shape"][1]
    block_maps = torch.randint(-2**31, 2**31 - 1, (n_terms, nb), generator=gen, device=dev,
                               dtype=torch.int32)
    bq = queries[:W_BLOCK_QUERIES].contiguous()
    n_blocks = n_docs // li.BLOCK_SIZE
    picks = torch.rand((W_BLOCK_QUERIES, n_blocks), generator=gen, device=dev).argsort(1)
    picks = picks[:, :li.CAND_BLOCKS].sort(1).values
    cand = (picks[:, :, None] * li.BLOCK_SIZE
            + torch.arange(li.BLOCK_SIZE, device=dev)).reshape(W_BLOCK_QUERIES, -1)
    cand = cand.to(torch.int32)
    allocated = {**params, "queries": bq, "block_maps": block_maps, "cand_docs": cand}
    bytes_ok.update({f"block.{n}": allocated[n].numel() * allocated[n].element_size()
                     == blk[n]["bytes"] for n in blk})
    if not all(bytes_ok.values()):
        raise AssertionError(f"W: allocated bytes differ from run()'s plan: {bytes_ok}")
    torch.cuda.reset_peak_memory_stats()
    block_ms, (anded, cand_hits) = _event_ms(
        lambda: li.block_step(params, bq, block_maps, cand), 1, 5)
    block_peak = torch.cuda.max_memory_allocated()
    from repro_torch.kernels.bitset.ref import bitset_and_popcount_ref

    want_and, _ = bitset_and_popcount_ref(block_maps[bq.clamp(min=0).long()],
                                          (bq >= 0).to(torch.int32))
    if not torch.equal(anded, want_and):
        raise AssertionError("W: block_step's block AND differs from bitset_and_popcount_ref")
    # the candidates' hits are the exhaustive words' bits at those docs, outside the margin
    bits = (words[:W_BLOCK_QUERIES].gather(1, (cand // 32).long()) >> (cand % 32)) & 1
    doc_rows = params["doc_embed"][cand.reshape(-1).long()].float().reshape(*cand.shape, e)
    logits = torch.einsum("qte,qce->qtc", params["term_embed"][bq.clamp(min=0).long()].float(),
                          doc_rows)
    del doc_rows
    btau = params["tau"][bq.clamp(min=0).long()]
    near = (((logits - btau[:, :, None]).abs() <= 1e-5 * (1 + btau.abs()[:, :, None]))
            & (bq >= 0)[:, :, None]).any(1)
    del logits
    mismatch = int(((bits.bool() != cand_hits) & ~near).sum())
    if mismatch:
        raise AssertionError(f"W: {mismatch} candidate hits differ from the exhaustive words")
    return {
        "phase": "W", "mesh": plan["serve_queries"]["mesh"],
        "cut": "one rank's share of the 256-rank mesh; queries draw their terms from the "
               "rank's 60,000-term shard, so no cross-rank gather",
        "serve_queries": {"docs": n_docs, "queries": q_exh, "slots": int(valid.sum()),
                          "words": n_words, "ms": ms, "first_call_ms": first_ms,
                          "peak_bytes": peak, "peak_over_base_bytes": peak - base,
                          "profile": profile,
                          "argument_bytes": plan["serve_queries"]["argument_bytes"],
                          "hits": hits, "fp32_flop": flop, "tflop_s": flop / ms / 1e9,
                          "bound_ms": max(bound.values()),
                          "bound_by": "operations" if bound["ops_ms"] >= bound["bytes_ms"]
                          else "bytes", "checks": checks,
                          "membership": membership},
        "serve_block": {"queries": W_BLOCK_QUERIES, "candidates": int(cand.shape[1]),
                        "ms": block_ms, "peak_bytes": block_peak,
                        "argument_bytes": plan["serve_block"]["argument_bytes"],
                        "surviving_block_bits": int(_popcount(anded)),
                        "candidate_hits": int(cand_hits.sum()),
                        "candidates_within_margin": int(near.sum())},
        "bytes_equal_plan": bytes_ok, "seconds": {**seconds, "total": time.perf_counter() - t0},
    }


# ------------------------------------------------------------ phases P and T
# P(a): the three hardest cells of the grid on the 16x16 mesh, gemma2-2b's
# prefill_32k, whose rank's share must fit the card (attention's scores split
# over ``model`` as the reference splits them), the recsys cells whose
# candidates and table rows split over ``model``, and the cells whose MLPs run
# tensor-parallel over ``model``; P(b): cut cells on a one-rank
# mesh against the same step run for real on the card
P_CELLS = (("deepseek-v3-671b", "train_4k"), ("dlrm-mlperf", "train_batch"),
           ("meshgraphnet", "ogb_products"), ("gemma2-2b", "prefill_32k"),
           ("bst", "retrieval_cand"), ("mind", "retrieval_cand"), ("mind", "train_batch"),
           ("bst", "train_batch"), ("dlrm-mlperf", "serve_bulk"),
           ("meshgraphnet", "minibatch_lg"))
P_FITS = (("gemma2-2b", "prefill_32k"),)  # a rank's peak under the card's memory
# the reference's plan of a rank (XLA's argument + output + temp bytes on the
# 16x16 mesh, from `JAX_PLATFORMS=cpu python -m repro.launch.dryrun --arch A
# --shape S`): the cells whose rows and candidates split over ``model`` must
# plan a rank's peak within P_PLAN_RATIO of it
P_PLANS = {("bst", "retrieval_cand"): 1_592_024_372, ("mind", "retrieval_cand"): 48_293_800,
           ("mind", "train_batch"): 560_673_828}
P_PLAN_RATIO = 2.0
# the reference's FLOPs a rank (XLA's cost_analysis on the 16x16 mesh, the same
# command): the cells whose MLPs run tensor-parallel over ``model`` must plan
# at most P_FLOPS_RATIO of them
P_FLOPS = {("bst", "train_batch"): 5_877_059_584, ("dlrm-mlperf", "serve_bulk"): 5_151_876_608,
           ("meshgraphnet", "minibatch_lg"): 9_651_743_744}
P_FLOPS_RATIO = 1.5
P_PEAK_TOL = 0.20
P_SEED = 43
P_TIMEOUT_S = 900  # the dry runs' processes, counted from the run's start


def _p_cut_cells():
    """(name, cell) of phase L's gemma2-2b cuts (prefill_32k at 2 x 4,096,
    train_4k at 1 x 4,096) and FM's train_batch at 65,536."""
    from repro_torch.common.config import ShapeSpec
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_cell

    lm, fm = get_arch(L_ARCH)[0], get_arch("fm")
    return (("gemma2-2b prefill 2x4096",
             build_cell(lm, ShapeSpec(name="prefill_32k", kind="prefill", seq_len=4096,
                                      global_batch=2))),
            ("gemma2-2b train 1x4096",
             build_cell(lm, ShapeSpec(name="train_4k", kind="train", seq_len=4096,
                                      global_batch=1))),
            ("fm train_batch 65536",
             build_cell(fm[0], next(s for s in fm[1] if s.name == "train_batch"))))


def _p_real(cell, dev) -> tuple[int, int, float]:
    """The cell's step once for real on the card -> (FlopCounterMode's FLOPs,
    the peak allocated bytes over the step, its ms)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.train import init_train_state

    gen = torch.Generator(device=dev).manual_seed(P_SEED)
    model = cell.init_fn(P_SEED, dev)
    opt = init_train_state(model, cell.opt_cfg) if cell.kind == "train" else None
    hi = getattr(cell.arch, "vocab_size", 0) or min(cell.arch.vocab_sizes or (2,))
    batch = {k: (torch.randint(0, hi, s.shape, generator=gen, device=dev, dtype=s.dtype)
                 if s.dtype == torch.int32 else
                 torch.randint(0, 2, s.shape, generator=gen, device=dev).to(s.dtype))
             for k, s in cell.input_specs.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        if cell.kind == "train":
            cell.step(model, opt, batch)
        else:
            cell.step(model, batch["tokens"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    del model, opt, batch
    return fc.get_total_flops(), peak, ms


def _p_fake_cuts(out: Path) -> int:
    """P(b)'s dry runs (``--p-fake``, in a process of their own): each cut
    cell's step on a one-rank mesh of a fake world -> JSON at ``out``."""
    from repro_torch.common.sharding import concrete_mesh
    from repro_torch.launch import dryrun

    res = {}
    for name, cell in _p_cut_cells():
        t0 = time.perf_counter()
        with dryrun.fake_world(1):
            r = dryrun._dryrun_bundle(cell, concrete_mesh((1, 1), ("data", "model")),
                                      device="cuda")
        res[name] = {**r, "seconds": time.perf_counter() - t0}
    out.write_text(json.dumps(res))
    return 0


def p_start(src: Path) -> list:
    """Phase P's dry runs, started as processes of their own when the run
    begins (they need host cores, not the card, and take minutes): P(a)'s
    cells through ``python -m repro_torch.launch.dryrun`` and P(b)'s
    cut cells through ``--p-fake``; ``phase_p`` collects them."""
    out = ROOT / "build" / "phase_p"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(src))
    cmds = {f"{arch}/{shape}": ([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                                 arch, "--shape", shape, "--out", str(out / f"a{i}.json")],
                                out / f"a{i}.json")
            for i, (arch, shape) in enumerate(P_CELLS)}
    cmds["b"] = ([sys.executable, str(ROOT / "chip_smoke.py"), "--p-fake", str(out / "b.json"),
                  "--src", str(src)], out / "b.json")
    procs = []
    for name, (cmd, path) in cmds.items():
        with open(path.with_suffix(".log"), "w") as err:
            procs.append((name, path, time.perf_counter(),
                          subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
                                           stderr=err)))
    return procs


def p_stop(procs: list) -> None:
    for *_, proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def phase_p(dev, procs: list) -> dict:
    """Phase P: the grid dry-run on the card's machine (fake tensors: no card
    memory).  (a) ``dryrun_cell`` on the 16x16 mesh for the three hardest
    cells, gemma2-2b's prefill_32k, the recsys cells of ``P_PLANS`` and the
    cells of ``P_FLOPS``, each ``ok``, gemma2-2b's peak a rank under the
    card's memory, the recsys cells' within ``P_PLAN_RATIO`` of the
    reference's plan, the ``P_FLOPS`` cells' FLOPs a rank within
    ``P_FLOPS_RATIO`` of the reference's (their MLPs tensor-parallel); (b)
    the dry run's body on a one-rank mesh against the same cut cell run
    for real here: FLOPs equal exactly, peaks within 20%.  A dry run that
    fails, or reports ``error``, fails the phase."""
    import torch

    out: dict = {"phase": "P", "a": {}, "b": {},
                 "card_bytes": torch.cuda.get_device_properties(0).total_memory}
    t_all = time.perf_counter()
    done = {}
    for name, path, t0, proc in procs:
        rc = proc.wait(timeout=P_TIMEOUT_S)
        if rc != 0 or not path.exists():
            log(path.with_suffix(".log").read_text()[-6000:])
            raise AssertionError(f"P: the dry run of {name} exited {rc}")
        done[name] = (json.loads(path.read_text()), time.perf_counter() - t0)
    for arch, shape in P_CELLS:
        rs, waited = done[f"{arch}/{shape}"]
        r = rs[0]
        if r["status"] != "ok":
            raise AssertionError(f"P(a): {arch} x {shape}: {r}")
        out["a"][f"{arch}/{shape}"] = {
            "process_seconds_by_collection": waited, "lower_s": r["lower_s"],
            "compile_s": r["compile_s"], "flops_per_device": r["flops_per_device"],
            "bytes_per_device": r["bytes_per_device"], "memory": r["memory"],
            "peak_bytes": r["peak_bytes"],
            "collective_bytes_per_device": r["collective_bytes_per_device"],
            "largest_collectives": [{k: e[k] for k in ("kind", "bytes", "op", "where",
                                                       "backward", "calls")}
                                    for e in r["largest_collectives"]]}
        log(f"[P] (a) {arch} x {shape}: peak {r['peak_bytes']:,} bytes a rank, the card "
            f"{out['card_bytes']:,}")
        if (arch, shape) in P_FITS and not r["peak_bytes"] < out["card_bytes"]:
            raise AssertionError(f"P(a): {arch} x {shape} plans {r['peak_bytes']} bytes a rank, "
                                 f"over the card's {out['card_bytes']}")
        plan = P_PLANS.get((arch, shape))
        if plan is not None:
            ratio = r["peak_bytes"] / plan
            out["a"][f"{arch}/{shape}"].update({"reference_plan_bytes": plan, "ratio": ratio})
            if ratio > P_PLAN_RATIO:
                raise AssertionError(f"P(a): {arch} x {shape} plans {r['peak_bytes']} bytes a "
                                     f"rank, {ratio:.2f}x the reference's {plan}")
        flops = P_FLOPS.get((arch, shape))
        if flops is not None:
            ratio = r["flops_per_device"] / flops
            out["a"][f"{arch}/{shape}"].update({"reference_flops": flops, "flops_ratio": ratio})
            log(f"[P] (a) {arch} x {shape}: {r['flops_per_device']:.6g} FLOPs a rank, "
                f"{ratio:.3f}x the reference's {flops:,}")
            if ratio > P_FLOPS_RATIO:
                raise AssertionError(f"P(a): {arch} x {shape} plans {r['flops_per_device']} "
                                     f"FLOPs a rank, {ratio:.2f}x the reference's {flops}")
    fakes = done["b"][0]
    for name, cell in _p_cut_cells():
        _free()
        fake = fakes[name]
        flops, peak, ms = _p_real(cell, dev)
        _free()
        rel = abs(fake["peak_bytes"] - peak) / peak
        out["b"][name] = {"fake_flops": fake["flops_per_device"], "real_flops": flops,
                          "fake_peak_bytes": fake["peak_bytes"], "real_peak_bytes": peak,
                          "peak_rel_diff": rel, "fake_seconds": fake["seconds"],
                          "real_step_ms": ms, "argument_bytes": fake["memory"]["argument_bytes"]}
        log(f"[P] (b) {name}: flops {fake['flops_per_device']} / {flops}, "
            f"peak {fake['peak_bytes']} / {peak} ({rel:.3f})")
        if fake["flops_per_device"] != flops:
            raise AssertionError(f"P(b) {name}: dry-run FLOPs {fake['flops_per_device']} "
                                 f"!= FlopCounterMode's {flops}")
        if rel > P_PEAK_TOL:
            raise AssertionError(f"P(b) {name}: dry-run peak {fake['peak_bytes']} vs "
                                 f"{peak} on the card ({rel:.3f} > {P_PEAK_TOL})")
    out["peak_tolerance"] = P_PEAK_TOL
    out["seconds"] = time.perf_counter() - t_all
    out["still_allocated_bytes"] = torch.cuda.memory_allocated()
    return out


# phase T's depth: train_lm's defaults are 300 steps, a checkpoint every 100;
# cut to keep the whole run inside its limit as phase X grew (its loss after
# 300 steps, 6.65, stands far under the uniform 10.37)
T_STEPS = 100
T_CHECKPOINT_EVERY = 50


def phase_t(dev) -> dict:
    """Phase T: ``launch/train_lm.py`` on the card at its defaults but the
    depth (gemma2-100m, ``T_STEPS`` steps of 8 x 128, a checkpoint every
    ``T_CHECKPOINT_EVERY``, 20 steps resumed)."""
    import math

    import torch

    from repro_torch.launch import train_lm

    ckpt = ROOT / "build" / "train_lm_ckpt"
    t0 = time.perf_counter()
    try:
        r = train_lm.run(ckpt_dir=str(ckpt), device=str(dev), steps=T_STEPS,
                         checkpoint_every=T_CHECKPOINT_EVERY)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if next(r["model"].parameters()).device.type != "cuda":
        raise AssertionError("T: the model did not train on the card")
    if not r["final_loss"] < math.log(32000) or r["resumed_from"] != T_STEPS:
        raise AssertionError(f"T: loss {r['final_loss']}, resumed from {r['resumed_from']}")
    ms = sorted(h["ms"] for h in r["history"][1:])
    step_ms = ms[len(ms) // 2]
    return {"phase": "T", "params": sum(p.numel() for p in r["model"].parameters()),
            "steps": len(r["history"]), "batch": 8, "seq": 128,
            "final_loss": r["final_loss"], "uniform_loss": math.log(32000),
            "resumed_from": r["resumed_from"], "resumed_steps": len(r["resumed"]),
            "resumed_final_loss": r["resumed"][-1]["loss"],
            "step0_ms": r["history"][0]["ms"], "median_step_ms": step_ms,
            "tokens_per_s": 8 * 128 * 1e3 / step_ms, "peak_bytes": r["peak_bytes"],
            "train_s": r["train_s"], "resume_s": r["resume_s"],
            "seconds": time.perf_counter() - t0}


def _popcount(words) -> int:
    """Set bits of an int32 word tensor."""
    import torch

    w = words.to(torch.int64) & 0xFFFFFFFF
    total = 0
    for b in range(32):
        total += int(((w >> b) & 1).sum())
    return total


# ------------------------------------------------------------ phase X
X_SEED = 31
X_RANKS = 4
X_FFN = (4096, 7168, 18432)  # deepseek-v3's dense FFN: (tokens, d_model, d_ff)
X_CAR = 64 * 2**20  # compressed all-reduce: fp32 elements a rank
X_PIPE = (4, 7168, 8, 512)  # stages, width, microbatches, rows a microbatch
X_MOE = (2, 4096)  # batch (train_4k's 256 cut to 2), sequence
X_DROP_CF = 0.5  # X4's second run: a capacity factor that drops slots
X_ATTN = (2, 4096)  # X5: batch, sequence of each attention layer
X_ATTN_LAYERS = (("gemma2-2b global", "gemma2-2b", False), ("gemma2-2b local", "gemma2-2b", True),
                 ("phi4-mini seq", "phi4-mini-3.8b", False),
                 ("deepseek-v2-lite MLA", "deepseek-v2-lite-16b", False))
X_TOL = (1e-5, 1e-4)  # X4's, X5's and X6's: absolute, relative
# X6: (name, arch, kind, batch or candidates) at full width on a (data 1,
# model 4) mesh; BST's 1,000,000 retrieval candidates cut to 262,144 (one
# process over 1,000,000 alone takes 42.5 GB, and the ranks share the card)
X_RECSYS = (("mind train_batch", "mind", "train", 65_536),
            ("mind retrieval_cand", "mind", "retrieval", 1_000_000),
            ("bst retrieval_cand", "bst", "retrieval", 262_144))
# X7: (arch, shape) of the cells whose MLPs run tensor-parallel over ``model``,
# at full width and the cells' own batches and graphs on that mesh
X_TP = (("bst", "train_batch"), ("bst", "serve_bulk"), ("meshgraphnet", "molecule"),
        ("meshgraphnet", "full_graph_sm"))
# X7's gradients: each leaf's relative Frobenius error.  Their (leaky) ReLUs'
# derivative jumps at 0, and a pre-activation within rounding of 0 takes the
# other branch on the mesh (its sums add in another order), so single
# elements move by up to a tenth of the leaf's largest at 65,536 rows; with a
# smooth activation in their place the elements agree to rounding.  A sum
# missed over the 4 ranks (a quarter of the gradient) or taken twice (double)
# is far beyond the bound.
X_TP_GRAD_TOL = 1e-2


def _x_tokens(d: int, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(X_SEED + 100)
    return torch.randn((*X_MOE, d), generator=gen, device=dev)


def _x_moe_globals(cfg, dev) -> dict:
    """Router, selection bias and shared expert, the same on every rank."""
    import math

    import torch

    gen = torch.Generator(device=dev).manual_seed(X_SEED + 101)
    d, e, fs = cfg.d_model, cfg.n_routed_experts, cfg.moe_d_ff * cfg.n_shared_experts
    return {
        "router": torch.randn((d, e), generator=gen, device=dev) / math.sqrt(d),
        "bias": 0.05 * torch.randn(e, generator=gen, device=dev),
        "shared_gate": torch.randn((d, fs), generator=gen, device=dev) / math.sqrt(d),
        "shared_up": torch.randn((d, fs), generator=gen, device=dev) / math.sqrt(d),
        "shared_down": torch.randn((fs, d), generator=gen, device=dev) / math.sqrt(fs),
    }


def _x_expert(cfg, e: int, dev):
    """Routed expert ``e``'s (w_gate, w_up, w_down), from its own generator."""
    import math

    import torch

    gen = torch.Generator(device=dev).manual_seed(X_SEED * 1_000_003 + e)
    d, f = cfg.d_model, cfg.moe_d_ff
    return (torch.randn((d, f), generator=gen, device=dev) / math.sqrt(d),
            torch.randn((d, f), generator=gen, device=dev) / math.sqrt(d),
            torch.randn((f, d), generator=gen, device=dev) / math.sqrt(f))


def _x_kernel_launches() -> int:
    """Launches of every kernel of the repo in this process."""
    import importlib

    total = 0
    for mod, attrs in (("membership", ("KERNEL", "MASKED")), ("bitset", ("KERNEL",)),
                       ("guided_search", ("KERNEL",)), ("plm_decode", ("KERNEL",)),
                       ("pfor", ("KERNEL",)), ("bm25_score", ("KERNEL",)),
                       ("fused_query", ("KERNEL",)), ("two_tier", ("KERNEL",)),
                       ("mlp_membership", ("KERNEL", "MASKED", "TWO_TIER"))):
        m = importlib.import_module(f"repro_torch.kernels.{mod}.kernel")
        total += sum(getattr(m, a).launches for a in attrs)
    from repro_torch.kernels.fused_query import dense

    return total + dense.launches


def _x_rank(rank: int, world: int, out_dir: str, backend: str) -> None:
    """One rank of phase X's world: X1-X5 (and, on NCCL, the DTensor train
    step), its numbers written to ``x_rank<r>.json``, X4's output by rank 0."""
    import math

    import torch
    from torch.distributed.tensor import DTensor, Shard

    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.common.sharding import concrete_mesh, mesh_context
    from repro_torch.configs import get_arch
    from repro_torch.distributed import (collective_matmul_ag, compressed_allreduce,
                                         make_pipeline_fn, matmul_reduce_scatter)
    from repro_torch.distributed.comm import HOST, all_gather
    from repro_torch.models import moe

    dev = torch.device("cuda", torch.cuda.current_device())
    res: dict = {"rank": rank, "backend": backend}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    def gen(seed: int):
        return torch.Generator(device=dev).manual_seed(seed)

    flat = concrete_mesh((world,), ("data",))

    # X1: collective matmuls at deepseek-v3's dense-FFN width
    m, k, n = X_FFN
    g = gen(X_SEED)
    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev) / math.sqrt(k)
    kl, nl = k // world, n // world
    want = x @ w[:, rank * nl:(rank + 1) * nl]
    x_sh = x[:, rank * kl:(rank + 1) * kl].contiguous()
    HOST.reset()
    ag, ag_s = timed(lambda: collective_matmul_ag(
        x_sh, w[:, rank * nl:(rank + 1) * nl].contiguous(), "data", flat))
    ag_bytes = HOST.bytes
    HOST.reset()
    rs, rs_s = timed(lambda: matmul_reduce_scatter(
        x_sh, w[rank * kl:(rank + 1) * kl].contiguous(), "data", flat))
    res["X1"] = {"shape": [m, k, n], "ag_rel_err": rel(ag, want), "rs_rel_err": rel(rs, want),
                 "ag_s": ag_s, "rs_s": rs_s, "host_bytes": ag_bytes + HOST.bytes}
    del x, w, want, x_sh, ag, rs
    torch.cuda.empty_cache()

    # X2: int8 ring all-reduce of 64M fp32 a rank
    mine = torch.randn(X_CAR, generator=gen(X_SEED + 1 + rank), device=dev)
    HOST.reset()
    out, car_s = timed(lambda: compressed_allreduce({"g": mine}, flat, "data")["g"])
    car_bytes = HOST.bytes
    del mine
    exact = torch.zeros(X_CAR, device=dev)
    for r in range(world):
        exact += torch.randn(X_CAR, generator=gen(X_SEED + 1 + r), device=dev)
    err = rel(out, exact)
    del exact
    parts = all_gather(out[None].view(torch.int32), "data", mesh=flat)
    same = all(torch.equal(parts[r], parts[0]) for r in range(world))
    res["X2"] = {"elements": X_CAR, "rel_err": err, "same_bits_on_every_rank": same,
                 "s": car_s, "host_bytes": car_bytes}
    del out, parts
    torch.cuda.empty_cache()

    # X3: GPipe over 4 stages of tanh(x @ W_s)
    stages, d, micro, rows = X_PIPE
    g = gen(X_SEED + 2)
    ws = torch.randn((stages, d, d), generator=g, device=dev) / math.sqrt(d)
    xs = torch.randn((micro, rows, d), generator=g, device=dev)
    pmesh = concrete_mesh((world,), ("pipe",))
    pf = make_pipeline_fn(lambda wp, h: torch.tanh(h @ wp), pmesh, stages)
    HOST.reset()
    got, pipe_s = timed(lambda: pf(ws, xs))
    seq = []
    for i in range(micro):  # microbatch by microbatch: the pipeline's products
        h = xs[i]
        for s in range(stages):
            h = torch.tanh(h @ ws[s])
        seq.append(h)
    seq = torch.stack(seq)
    res["X3"] = {"max_abs_err": float((got - seq).abs().max()), "s": pipe_s,
                 "host_bytes": HOST.bytes}
    del got, seq
    # X3's backward: gradients of sum(y * cot) by the reverse schedule
    # against autograd through the sequential product
    cot = torch.randn((micro, rows, d), generator=g, device=dev)
    w_p, x_p = ws.clone().requires_grad_(), xs.clone().requires_grad_()
    HOST.reset()
    _, back_s = timed(lambda: (pf(w_p, x_p) * cot).sum().backward())
    w_q, x_q = ws.clone().requires_grad_(), xs.clone().requires_grad_()
    for i in range(micro):  # microbatch by microbatch: the pipeline's products
        h = x_q[i]
        for s in range(stages):
            h = torch.tanh(h @ w_q[s])
        (h * cot[i]).sum().backward()
    res["X3"].update({"grad_rel_err": max(rel(w_p.grad, w_q.grad), rel(x_p.grad, x_q.grad)),
                      "backward_s": back_s, "backward_host_bytes": HOST.bytes})
    del ws, xs, cot, w_p, x_p, w_q, x_q, h
    torch.cuda.empty_cache()

    # X4: deepseek-v3's routed experts over (data 2, model 2), 64 a rank
    cfg = get_arch("deepseek-v3-671b")[0]
    mesh = concrete_mesh((2, 2), ("data", "model"))
    t0 = time.perf_counter()
    e_loc = cfg.n_routed_experts // world
    d, f = cfg.d_model, cfg.moe_d_ff
    local = [torch.empty((e_loc, *shape), device=dev) for shape in ((d, f), (d, f), (f, d))]
    for i in range(e_loc):  # this rank's experts only, drawn one by one
        for dst, w_e in zip(local, _x_expert(cfg, rank * e_loc + i, dev)):
            dst[i] = w_e
    params = _x_moe_globals(cfg, dev)
    for name, w_loc in zip(("w_gate", "w_up", "w_down"), local):
        params[name] = DTensor.from_local(w_loc, mesh, (Shard(0), Shard(0)), run_check=False)
    del local
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    x = _x_tokens(cfg.d_model, dev)
    weight_bytes = sum(params[nm].to_local().numel() * 4 for nm in ("w_gate", "w_up", "w_down"))
    torch.cuda.reset_peak_memory_stats()
    HOST.reset()
    with mesh_context(mesh):
        y, moe_s = timed(lambda: moe.moe_dispatch(params, cfg, x))
    res["X4"] = {"draw_s": draw_s, "s": moe_s, "host_bytes": HOST.bytes,
                 "host_calls": HOST.calls, "weight_bytes": weight_bytes,
                 "peak_bytes": torch.cuda.max_memory_allocated()}
    if HOST.bytes == 0 and backend == "gloo":
        raise AssertionError("X4 moved nothing through the host: the all-to-all path did not run")
    with mesh_context(mesh):  # again at a capacity that drops slots
        y_drop, drop_s = timed(lambda: moe.moe_dispatch(
            params, cfg.replace(moe_capacity_factor=X_DROP_CF), x))
    res["X4"]["drop_s"] = drop_s
    if rank == 0:
        torch.save({"y": y.cpu(), "y_drop": y_drop.cpu()}, os.path.join(out_dir, "x4_y.pt"))
    del params, x, y, y_drop
    torch.cuda.empty_cache()

    res["X5"] = _x_attention(rank, dev, backend)
    res["X6"] = _x_recsys(rank, dev, backend)
    res["X7"] = _x_mlp_tp(rank, dev, backend)
    if backend == "nccl":
        res["train"] = _x_train_step(rank, dev)
    res["kernel_launches"] = _x_kernel_launches()
    with open(os.path.join(out_dir, f"x_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _x_over(got, want) -> int:
    """Elements of ``got`` beyond ``X_TOL`` of ``want``."""
    atol, rtol = X_TOL
    return int(((got - want).abs() > atol + rtol * want.abs()).sum())


def _x_attention(rank: int, dev, backend: str) -> dict:
    """X5: one full-width attention layer of each of ``X_ATTN_LAYERS`` on a
    (data 1, model 4) mesh, 2 x 4,096 tokens, fp32, forward and backward
    (the gradient of y . cot summed over the width, averaged over the
    tokens), the scores split over ``model`` as the reference splits them
    (``spec_for_shape``: gemma2-2b's 8 heads and deepseek-v2-lite's 16 by
    head, phi4-mini's ``seq`` mode by query position).  Rank 0 then runs the
    same layer in one process on this card and counts the output and
    gradient elements beyond ``X_TOL``; every rank reports its peak bytes
    over the call, absolute and over what it held before the call.  On gloo DTensor's collectives go through host memory
    (``comm.host_collectives``)."""
    from contextlib import nullcontext

    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.common.sharding import concrete_mesh, mesh_context, sharding_for_shape
    from repro_torch.configs import get_arch
    from repro_torch.distributed.comm import HOST, host_collectives
    from repro_torch.models import attention as attn

    mesh = concrete_mesh((1, X_RANKS), ("data", "model"))
    via_host = host_collectives if backend == "gloo" else nullcontext
    b, s = X_ATTN
    out = {}

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from (leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)])

    def rebuild(flat):
        tree: dict = {}
        for n, t in flat.items():
            head, _, leaf = n.rpartition(".")
            (tree.setdefault(head, {}) if head else tree)[leaf] = t
        return tree

    for name, arch, local in X_ATTN_LAYERS:
        cfg = get_arch(arch)[0]
        init, fn = ((attn.init_mla, attn.mla_attention) if cfg.use_mla
                    else (attn.init_gqa, attn.gqa_attention))

        def call(params, x, cot, window, fn=fn, cfg=cfg):
            y, _ = fn(params, cfg, x, torch.arange(s, dtype=torch.int32, device=dev)[None, :],
                      window=window)
            (y * cot).sum(-1).mean().backward()
            return y

        gen = torch.Generator(device=dev).manual_seed(X_SEED + 5)
        params, axes = init(gen, cfg, device=dev)
        params, axes = dict(leaves(params)), dict(leaves(axes))
        for n, w in params.items():  # the norms' zero scales drawn too
            if n.endswith("scale"):
                w.normal_(0.0, 0.3, generator=gen)
        x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
        cot = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
        window = cfg.window_size if local else None

        def place(t, ax):
            return distribute_tensor(t, mesh, sharding_for_shape(ax, tuple(t.shape), mesh),
                                     src_data_rank=None)

        on_mesh = {n: place(w, axes[n]).requires_grad_() for n, w in params.items()}
        x_m = place(x, ("batch", None, None)).requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        HOST.reset()
        t0 = time.perf_counter()
        with mesh_context(mesh), via_host():
            y = call(rebuild(on_mesh), x_m, place(cot, ("batch", None, None)), window)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            row = {"s": time.perf_counter() - t0, "peak_bytes": peak,
                   "peak_over_base_bytes": peak - base, "host_bytes": HOST.bytes}
            got = {"y": y.detach().full_tensor(), "x": x_m.grad.full_tensor(),
                   **{n: w.grad.full_tensor() for n, w in on_mesh.items()}}
        del y, on_mesh, x_m
        if rank == 0:  # the same layer in one process on this card
            one = {n: w.clone().requires_grad_() for n, w in params.items()}
            x_1 = x.clone().requires_grad_()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            y = call(rebuild(one), x_1, cot, window)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            row.update({"one_process_s": time.perf_counter() - t0,
                        "one_process_peak_bytes": peak,
                        "one_process_peak_over_base_bytes": peak - base})
            want = {"y": y.detach(), "x": x_1.grad, **{n: w.grad for n, w in one.items()}}
            row["over"] = {k: _x_over(got[k], want[k]) for k in want}
            row["max_abs_err"] = {k: float((got[k] - want[k]).abs().max()) for k in want}
            row["max_abs"] = {k: float(want[k].abs().max()) for k in want}
            del y, one, x_1, want
        out[name] = row
        del got, params, x, cot
        torch.cuda.empty_cache()
    return out


def _x_recsys(rank: int, dev, backend: str) -> dict:
    """X6: ``X_RECSYS`` at full width on a (data 1, model 4) mesh, fp32,
    the item table's rows and the candidates split over ``model`` (each
    rank looks up, encodes and scores its own candidates; MIND's train
    step sums its table's gradient into each rank's block).  Rank 0 then
    runs the same case in one process on this card: the scores within
    ``X_TOL``, the top-100 ids equal wherever neighbouring scores differ
    by more than that, the loss within 1e-5 relative and every gradient
    within 1e-5 of its largest element.  Every rank reports its peak bytes
    over what it held before the case and its host bytes."""
    from contextlib import nullcontext

    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.common.config import ShapeSpec
    from repro_torch.common.sharding import (concrete_mesh, is_dtensor, mesh_context,
                                             shard_module, sharding_for_shape)
    from repro_torch.configs import get_arch
    from repro_torch.distributed.comm import HOST, host_collectives
    from repro_torch.launch.steps import recsys_cell
    from repro_torch.models import recsys
    from repro_torch.models.moe import top_k_lowest_index

    mesh = concrete_mesh((1, X_RANKS), ("data", "model"))
    via_host = host_collectives if backend == "gloo" else nullcontext
    atol, rtol = X_TOL
    out = {}
    for name, arch, kind, n in X_RECSYS:
        cfg = get_arch(arch)[0]
        v = cfg.vocab_sizes[0]
        gen = torch.Generator(device=dev).manual_seed(X_SEED + 6)

        def ids(*shape):
            return torch.randint(0, v, shape, generator=gen, device=dev, dtype=torch.int32)

        if kind == "train":
            batch = {"hist": ids(n, cfg.hist_len), "target": ids(n),
                     "label": torch.randint(0, 2, (n,), generator=gen, device=dev).float()}
            axes = {"hist": ("batch", None), "target": ("batch",), "label": ("batch",)}
        else:
            batch = {"hist": ids(1, cfg.hist_len), "candidates": ids(n)}
            axes = {"hist": ("batch", None), "candidates": ("candidates",)}
            cell = recsys_cell(cfg, ShapeSpec(name=name, kind=kind, global_batch=1,
                                              n_candidates=n))

        def run(model, batch, kind=kind, cfg=cfg, arch=arch):
            if kind == "train":
                loss = recsys.recsys_loss(model, cfg, batch)
                loss.backward()
                return {"loss": loss.detach(),
                        **{p_name: p.grad for p_name, p in model.named_parameters()}}
            with torch.no_grad():
                rest = {"hist": batch["hist"]}
                return {"scores": recsys.RETRIEVAL[arch](model, cfg, rest, batch["candidates"]),
                        "ids": cell.step(model, batch)[1]}

        model, p_axes = recsys.INIT[arch](X_SEED, cfg, device=dev)
        shard_module(model, p_axes, mesh, src_data_rank=None)
        placed = {k: distribute_tensor(t, mesh, sharding_for_shape(axes[k], tuple(t.shape), mesh),
                                       src_data_rank=None) for k, t in batch.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        HOST.reset()
        t0 = time.perf_counter()
        with mesh_context(mesh), via_host():
            res = run(model, placed)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            row = {"s": time.perf_counter() - t0, "peak_bytes": peak,
                   "peak_over_base_bytes": peak - base, "host_bytes": HOST.bytes}
            if kind == "retrieval":
                row["score_block"] = list(res["scores"].to_local().shape)
            got = {k: t.full_tensor() if is_dtensor(t) else t for k, t in res.items()}
        del model, placed, res
        torch.cuda.empty_cache()
        if rank == 0:  # the same case in one process on this card
            one = recsys.INIT[arch](X_SEED, cfg, device=dev)[0]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            want = run(one, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            row.update({"one_process_s": time.perf_counter() - t0,
                        "one_process_peak_bytes": peak,
                        "one_process_peak_over_base_bytes": peak - base})
            if kind == "train":
                row["loss"] = [float(got["loss"]), float(want["loss"])]
                row["loss_rel_err"] = abs(row["loss"][0] - row["loss"][1]) / abs(row["loss"][1])
                row["grad_err_over_max"] = {
                    k: float((got[k] - want[k]).abs().max() / want[k].abs().max())
                    for k in want if k != "loss"}
            else:
                s1 = want["scores"]
                row["over"] = _x_over(got["scores"], s1)
                row["max_abs_err"] = float((got["scores"] - s1).abs().max())
                row["max_abs"] = float(s1.abs().max())
                # the top 100 where each score stands clear of its neighbours
                top, _ = top_k_lowest_index(s1, 101)
                gap = top[:-1] - top[1:]
                tol = atol + rtol * top[:-1].abs()
                clear = (gap > tol) & (torch.cat([gap.new_full((1,), float("inf")),
                                                  gap[:-1]]) > tol)
                row["top_differ"] = int(((got["ids"] != want["ids"]) & clear).sum())
                row["top_clear"] = int(clear.sum())
                # ids the mesh ranks in its top 100 whose one-process score is
                # below the 100th by more than the tolerance
                row["top_outside"] = int((s1[got["ids"].long()] < top[99] - atol
                                          - rtol * top[99].abs()).sum())
            del one, want
        out[name] = row
        del got, batch
        torch.cuda.empty_cache()
    return out


def _x_mlp_tp(rank: int, dev, backend: str) -> dict:
    """X7: ``X_TP`` at full width on a (data 1, model 4) mesh, fp32: the
    MLPs' hidden units split over ``model`` (BST's FFN and head, every MLP
    of MeshGraphNet), each rank its block of units or its partial product,
    summed.  Train cells: the loss and every gradient; serve: the scores.
    Each case runs twice on the mesh: once for its seconds, peak over what
    the rank held before and host bytes, once under the dry run's counter
    below DTensor for a rank's FLOPs and the all-gathers of a whole MLP
    weight (none may be).  Rank 0 then runs the case in one process on
    this card (and once more under ``FlopCounterMode``): the scores and the
    loss within ``X_TOL``, every gradient within ``X_TP_GRAD_TOL`` relative
    (Frobenius), its worst element reported."""
    import re
    from contextlib import nullcontext

    import torch
    from torch.distributed.tensor import distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.common.sharding import (concrete_mesh, is_dtensor, mesh_context,
                                             shard_module, sharding_for_shape)
    from repro_torch.configs import get_arch
    from repro_torch.distributed.comm import HOST, host_collectives
    from repro_torch.launch.dryrun import _rank_ops_mode
    from repro_torch.launch.steps import build_cell, gnn_graph_dims
    from repro_torch.models import gnn, recsys

    mesh = concrete_mesh((1, X_RANKS), ("data", "model"))
    via_host = host_collectives if backend == "gloo" else nullcontext
    mlp_weight = re.compile(r"(^|\.)\d+\.[wb]$")
    out = {}
    for arch, shape_name in X_TP:
        cfg, shapes, _ = get_arch(arch)
        shape = next(s for s in shapes if s.name == shape_name)
        cell = build_cell(cfg, shape)
        gen = torch.Generator(device=dev).manual_seed(X_SEED + 7)
        if cfg.family == "gnn":
            n, e, d_feat = gnn_graph_dims(shape)
            graphs = shape.n_graphs or 1
            batch = _graph_batch(n, e, d_feat, cell.arch, shape.n_nodes * graphs,
                                 shape.n_edges * graphs, gen, dev)
        else:
            batch = _rec_batch(cell.arch, shape.global_batch, gen, dev,
                               label=cell.kind == "train")

        def run(model, batch, cell=cell):
            if cell.kind == "serve":
                with torch.no_grad():
                    return {"scores": cell.step(model, batch)}
            if cell.arch.family == "gnn":
                loss = gnn.mgn_loss(model, cell.arch, batch)
            else:
                loss = recsys.recsys_loss(model, cell.arch, batch)
            loss.backward()
            return {"loss": loss.detach(),
                    **{name: p.grad for name, p in model.named_parameters()}}

        model = cell.init_fn(X_SEED, dev)
        shard_module(model, cell.param_axes, mesh, src_data_rank=None)
        whole = {tuple(p.shape) for name, p in model.named_parameters() if mlp_weight.search(name)}
        placed = {k: distribute_tensor(t, mesh, sharding_for_shape(cell.input_axes[k],
                                                                   tuple(t.shape), mesh),
                                       src_data_rank=None) for k, t in batch.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        HOST.reset()
        t0 = time.perf_counter()
        with mesh_context(mesh), via_host():
            res = run(model, placed)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            row = {"s": time.perf_counter() - t0, "peak_bytes": peak,
                   "peak_over_base_bytes": peak - base, "host_bytes": HOST.bytes}
            got = {k: t.full_tensor() if is_dtensor(t) else t for k, t in res.items()}
            del res
            for p in model.parameters():
                p.grad = None
            ops = _rank_ops_mode()
            with ops:
                run(model, placed)
        row["flops"] = ops.flops
        row["collective_bytes"] = dict(ops.collectives)
        row["whole_weight_gathers"] = sum(
            e["kind"] == "all-gather" and any(tuple(s) in whole for s in e["shape"])
            for e in ops.events)
        del model, placed
        torch.cuda.empty_cache()
        if rank == 0:  # the same case in one process on this card
            one = cell.init_fn(X_SEED, dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            want = run(one, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            row.update({"one_process_s": time.perf_counter() - t0,
                        "one_process_peak_bytes": peak,
                        "one_process_peak_over_base_bytes": peak - base})
            if "loss" in want:
                row["loss"] = [float(got["loss"]), float(want["loss"])]
                row["loss_rel_err"] = abs(row["loss"][0] - row["loss"][1]) / abs(row["loss"][1])
                row["grad_err_over_max"] = {
                    k: float((got[k] - want[k]).abs().max() / want[k].abs().max())
                    for k in want if k != "loss"}
                row["grad_rel_norm_err"] = {
                    k: float((got[k] - want[k]).norm() / want[k].norm())
                    for k in want if k != "loss"}
            else:
                s1 = want["scores"]
                row["over"] = _x_over(got["scores"], s1)
                row["max_abs_err"] = float((got["scores"] - s1).abs().max())
                row["max_abs"] = float(s1.abs().max())
            del want
            for p in one.parameters():
                p.grad = None
            with FlopCounterMode(display=False) as fc:
                run(one, batch)
            row["one_process_flops"] = fc.get_total_flops()
            del one
        out[f"{arch} {shape_name}"] = row
        del got, batch
        torch.cuda.empty_cache()
    return out


def _x_train_step(rank: int, dev) -> dict:
    """Reduced gemma2-2b, one AdamW step (fp32 compute) on a (2, 2) DTensor
    mesh by the production rules, against the one-process step on this card."""
    import torch

    from repro_torch.common.config import ShapeSpec
    from repro_torch.common.sharding import concrete_mesh
    from repro_torch.configs import get_arch, reduce_config
    from repro_torch.launch.mesh import sharded_step_vs_one_process
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as tf
    from repro_torch.train import make_train_step

    rc = reduce_config(get_arch("gemma2-2b")[0]).replace(d_model=64, n_heads=4, head_dim=16)
    cell = build_cell(rc, ShapeSpec(name="t", kind="train", seq_len=32, global_batch=8))
    step = make_train_step(lambda m, b: tf.lm_loss(m, rc, b, compute_dtype=torch.float32,
                                                   remat="dots"), cell.opt_cfg)
    gen = torch.Generator(device=dev).manual_seed(X_SEED + 3)
    batch = {k: torch.randint(0, rc.vocab_size, (8, 32), generator=gen, device=dev,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    return sharded_step_vs_one_process(cell, step, cell.opt_cfg, cell.init_fn(0, dev), batch,
                                       concrete_mesh((2, 2), ("data", "model")))


def _x_world(backend: str, out_dir: Path) -> list[dict]:
    from repro_torch.distributed.comm import run_world

    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    run_world(_x_rank, X_RANKS, str(out_dir), backend, backend=backend, timeout_s=1200.0)
    ranks = [json.loads((out_dir / f"x_rank{r}.json").read_text()) for r in range(X_RANKS)]
    for r in ranks:
        x1, x2, x3 = r["X1"], r["X2"], r["X3"]
        if max(x1["ag_rel_err"], x1["rs_rel_err"]) > 1e-4:
            raise AssertionError(f"X1 ({backend}) rank {r['rank']}: {x1}")
        if not x2["same_bits_on_every_rank"] or x2["rel_err"] >= 5e-2:
            raise AssertionError(f"X2 ({backend}) rank {r['rank']}: {x2}")
        if x3["max_abs_err"] > 1e-5 or x3["grad_rel_err"] > 1e-5:
            raise AssertionError(f"X3 ({backend}) rank {r['rank']}: {x3}")
        if r["kernel_launches"]:
            raise AssertionError(f"X ({backend}) rank {r['rank']} launched the repo's kernels")
        for name, row in r["X5"].items():
            if any(row.get("over", {}).values()):
                raise AssertionError(f"X5 ({backend}) {name}: elements beyond {X_TOL} of one "
                                     f"process: {row['over']} (max abs err "
                                     f"{row['max_abs_err']})")
        for name, row in r["X6"].items() if r["rank"] == 0 else ():  # rank 0 compares
            if "loss" in row:
                worst = max(row["grad_err_over_max"].values())
                if row["loss_rel_err"] > 1e-5 or worst > 1e-5:
                    raise AssertionError(f"X6 ({backend}) {name}: loss rel err "
                                         f"{row['loss_rel_err']}, gradients "
                                         f"{row['grad_err_over_max']} of their largest")
            elif row["over"] or row["top_differ"] or row["top_outside"]:
                raise AssertionError(f"X6 ({backend}) {name}: {row['over']} scores beyond "
                                     f"{X_TOL} of one process (max abs err "
                                     f"{row['max_abs_err']}), {row['top_differ']} top-100 ids "
                                     f"differ where the scores stand clear, "
                                     f"{row['top_outside']} below the 100th")
        for name, row in r["X7"].items():
            if row["whole_weight_gathers"]:
                raise AssertionError(f"X7 ({backend}) {name} rank {r['rank']}: "
                                     f"{row['whole_weight_gathers']} all-gathers of a whole "
                                     f"MLP weight")
            if r["rank"] != 0:
                continue
            if "loss" in row:
                worst = max(row["grad_rel_norm_err"].values())
                got, want = row["loss"]
                if abs(got - want) > X_TOL[0] + X_TOL[1] * abs(want) or worst > X_TP_GRAD_TOL:
                    raise AssertionError(f"X7 ({backend}) {name}: loss {got} vs {want}, "
                                         f"gradients' relative errors {row['grad_rel_norm_err']}")
            elif row["over"]:
                raise AssertionError(f"X7 ({backend}) {name}: {row['over']} scores beyond "
                                     f"{X_TOL} of one process (max abs err "
                                     f"{row['max_abs_err']})")
        if "train" in r:
            tr = r["train"]
            for k in ("loss", "grad_norm"):
                if abs(tr[k][0] - tr[k][1]) > 1e-5 * abs(tr[k][1]):
                    raise AssertionError(f"X train ({backend}) rank {r['rank']}: {tr}")
            for name, v in tr["leaves"].items():
                if v["grad_diff"] > 1e-5 * v["grad_max"] or v["param_diff"] > 0.05 * tr["lr"]:
                    raise AssertionError(f"X train ({backend}) rank {r['rank']} {name}: {v}")
    return ranks


def _x_check_moe(dev, out_dir: Path) -> dict:
    """X4 against ``moe_a2a_ref`` in this process, every token, one expert
    drawn at a time, with the shared expert written out here: 1e-5 + 1e-4
    relative, at the config's capacity factor and at one that drops."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.models.moe_a2a import a2a_capacity, moe_a2a_ref

    cfg = get_arch("deepseek-v3-671b")[0]
    got = torch.load(out_dir / "x4_y.pt")
    x = _x_tokens(cfg.d_model, dev)
    glob = _x_moe_globals(cfg, dev)
    shared = (F.silu(x @ glob["shared_gate"]) * (x @ glob["shared_up"])) @ glob["shared_down"]
    out = {"drop_capacity_factor": X_DROP_CF}
    for key, cf in (("y", cfg.moe_capacity_factor), ("y_drop", X_DROP_CF)):
        t0 = time.perf_counter()
        routed, dropped = moe_a2a_ref(x, glob["router"], glob["bias"],
                                      lambda e: _x_expert(cfg, e, dev),
                                      cfg.replace(moe_capacity_factor=cf), 2, 2)
        want = routed + shared
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        err = (got[key].to(dev) - want).abs()
        over = int((err > 1e-5 + 1e-4 * want.abs()).sum())
        if over:
            raise AssertionError(f"X4 ({key}): {over} outputs differ from moe_a2a_ref beyond "
                                 f"1e-5 + 1e-4 rel")
        if key == "y_drop" and not 0.0 < dropped < 1.0:
            raise AssertionError(f"X4: capacity factor {cf} dropped a share of {dropped}")
        tag = "" if key == "y" else "drop_"
        out.update({f"{tag}max_abs_err": float(err.max()),
                    f"{tag}max_abs_out": float(want.abs().max()),
                    f"{tag}dropped_share": dropped, f"{tag}ref_s": ref_s})
    cap = a2a_capacity(cfg, X_MOE[0] * X_MOE[1] // X_RANKS, X_RANKS)  # the send buffers'
    out.update({"capacity": cap, "send_buffer_bytes": X_RANKS * (cap + 1) * cfg.d_model * 4})
    return out


def phase_x(dev) -> dict:
    """Phase X: the mesh world, 4 ranks on the card over gloo (each
    collective through host memory), then on NCCL where there are 4 cards."""
    import torch

    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "phase_x"
    ranks = _x_world("gloo", out_dir)
    moe_check = _x_check_moe(dev, out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    worst = {k: max(r[k][f] for r in ranks) for k, f in
             (("X1", "ag_rel_err"), ("X2", "rel_err"), ("X3", "max_abs_err"))}
    result = {
        "phase": "X", "world": X_RANKS, "backend": "gloo",
        "passed": ["X1", "X2", "X3", "X4", "X5", "X6", "X7"],
        "transport": "one card: gloo moves CUDA tensors through host memory (copied out and "
                     "back by the comm helpers); times are the host transport's, not the card's",
        "X1": {"shape": ranks[0]["X1"]["shape"], "worst_rel_err": worst["X1"],
               "ag_s": [r["X1"]["ag_s"] for r in ranks], "rs_s": [r["X1"]["rs_s"] for r in ranks],
               "host_bytes": [r["X1"]["host_bytes"] for r in ranks]},
        "X2": {"elements": X_CAR, "worst_rel_err": worst["X2"], "same_bits": True,
               "s": [r["X2"]["s"] for r in ranks],
               "host_bytes": [r["X2"]["host_bytes"] for r in ranks]},
        "X3": {"shape": list(X_PIPE), "worst_max_abs_err": worst["X3"],
               "s": [r["X3"]["s"] for r in ranks],
               "host_bytes": [r["X3"]["host_bytes"] for r in ranks],
               "worst_grad_rel_err": max(r["X3"]["grad_rel_err"] for r in ranks),
               "backward_s": [r["X3"]["backward_s"] for r in ranks],
               "backward_host_bytes": [r["X3"]["backward_host_bytes"] for r in ranks]},
        "X4": {"arch": "deepseek-v3-671b", "tokens": list(X_MOE),
               "cut": "train_4k's batch of 256 cut to 2",
               "draw_s": [r["X4"]["draw_s"] for r in ranks], "s": [r["X4"]["s"] for r in ranks],
               "drop_s": [r["X4"]["drop_s"] for r in ranks],
               "host_bytes": [r["X4"]["host_bytes"] for r in ranks],
               "weight_bytes": [r["X4"]["weight_bytes"] for r in ranks],
               "peak_bytes": [r["X4"]["peak_bytes"] for r in ranks], **moe_check},
        "X5": {"tokens": list(X_ATTN), "mesh": [1, X_RANKS], "tolerance": list(X_TOL),
               "layers": {name: {**ranks[0]["X5"][name],
                                 "s": [r["X5"][name]["s"] for r in ranks],
                                 "peak_bytes": [r["X5"][name]["peak_bytes"] for r in ranks],
                                 "peak_over_base_bytes": [r["X5"][name]["peak_over_base_bytes"]
                                                          for r in ranks],
                                 "host_bytes": [r["X5"][name]["host_bytes"] for r in ranks]}
                          for name, *_ in X_ATTN_LAYERS}},
        "X6": {"mesh": [1, X_RANKS], "tolerance": list(X_TOL),
               "cut": "bst retrieval_cand's 1,000,000 candidates cut to 262,144",
               "cases": {name: {**ranks[0]["X6"][name],
                                **{k: [r["X6"][name][k] for r in ranks]
                                   for k in ("s", "peak_bytes", "peak_over_base_bytes",
                                             "host_bytes")}}
                         for name, *_ in X_RECSYS}},
        "X7": {"mesh": [1, X_RANKS], "tolerance": list(X_TOL),
               "grad_tolerance": X_TP_GRAD_TOL,
               "cases": {name: {**{k: v for k, v in ranks[0]["X7"][name].items()
                                   if not k.startswith("grad_")},
                                **{f"worst_{k}": max(ranks[0]["X7"][name][k].values())
                                   for k in ("grad_err_over_max", "grad_rel_norm_err")
                                   if k in ranks[0]["X7"][name]},
                                **{k: [r["X7"][name][k] for r in ranks]
                                   for k in ("s", "flops", "peak_bytes", "peak_over_base_bytes",
                                             "host_bytes")}}
                         for name in ranks[0]["X7"]}},
        "kernel_launches": 0,
    }
    if torch.cuda.device_count() >= X_RANKS:
        nccl = _x_world("nccl", out_dir)
        result["nccl"] = {
            "X1_worst_rel_err": max(max(r["X1"]["ag_rel_err"], r["X1"]["rs_rel_err"])
                                    for r in nccl),
            "X2_worst_rel_err": max(r["X2"]["rel_err"] for r in nccl),
            "X3_worst_max_abs_err": max(r["X3"]["max_abs_err"] for r in nccl),
            "X3_worst_grad_rel_err": max(r["X3"]["grad_rel_err"] for r in nccl),
            "X4_s": [r["X4"]["s"] for r in nccl], "X1_ag_s": [r["X1"]["ag_s"] for r in nccl],
            "X2_s": [r["X2"]["s"] for r in nccl], "X3_s": [r["X3"]["s"] for r in nccl],
            "train": nccl[0]["train"], "X4": _x_check_moe(dev, out_dir),
            "X5": nccl[0]["X5"], "X6": nccl[0]["X6"], "X7": nccl[0]["X7"]}
        shutil.rmtree(out_dir, ignore_errors=True)
    else:
        result["nccl"] = (f"not run: {torch.cuda.device_count()} card(s); the NCCL world "
                          f"needs {X_RANKS}, one rank a card")
    result["seconds"] = time.perf_counter() - t0
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=528_000,
                    help="documents in phase A's collection (Robust04's 528k by default)")
    ap.add_argument("--phases", default="ABRSQMKWDCLGEPTX",
                    help="phases to run (R and D need A; S and Q need A and R; M needs A, R "
                         "and S; C needs A, B and R; W, the learned index at ClueWeb09B "
                         "scale, L, the LM stack, G, the GNN, E, the recsys family, P, the "
                         "grid dry-run, T, the train_lm example, and X, the mesh world, "
                         "need none)")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the directory that holds the repro_torch package to drive")
    ap.add_argument("--p-fake", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.p_fake is not None:  # phase P's one-rank dry runs, in a process of their own
        sys.path.insert(0, str(args.src.resolve()))
        return _p_fake_cuts(args.p_fake)
    phases = set(args.phases.upper())
    if ({"R", "D"} & phases and "A" not in phases) or ("C" in phases and not {"A", "B", "R"} <= phases) \
            or ({"S", "Q"} & phases and not {"A", "R"} <= phases) \
            or ("M" in phases and not {"A", "R", "S"} <= phases):
        ap.error(f"--phases {args.phases}: R and D need A, S and Q need A and R, M needs A, R "
                 f"and S, and C needs A, B and R")

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's kernels need one")
        return 1
    src = args.src.resolve()
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
    from repro_torch.kernels.membership.kernel import MASKED as MEMBERSHIP_MASKED
    from repro_torch.kernels.plm_decode import ops as decode_ops
    from repro_torch.kernels.plm_decode.kernel import KERNEL as DECODE
    from repro_torch.kernels.pfor import ops as pfor_ops
    from repro_torch.kernels.pfor.kernel import KERNEL as PFOR
    from repro_torch.kernels.bm25_score import ops as bm25_ops
    from repro_torch.kernels.bm25_score.kernel import KERNEL as BM25
    from repro_torch.kernels.fused_query import dense
    from repro_torch.kernels.fused_query import ops as fused_ops
    from repro_torch.kernels.fused_query.kernel import KERNEL as FUSED

    kernels = {"membership": MEMBERSHIP, "membership_masked": MEMBERSHIP_MASKED,
               "bitset": BITSET, "guided_search": GUIDED, "plm_decode": DECODE, "pfor": PFOR,
               "bm25_score": BM25, "fused_topk": FUSED}
    if hasattr(dense, "KERNEL"):  # a package whose dense pass is a kernel
        kernels["dense_topk"] = dense.KERNEL
    if "S" in phases:  # a package with Algorithm 2's kernel
        from repro_torch.kernels.two_tier.kernel import KERNEL as TWO_TIER

        kernels["two_tier"] = TWO_TIER
    if "M" in phases:  # a package with the MLP head's kernels
        from repro_torch.kernels.mlp_membership import kernel as mlp

        kernels["mlp_membership"] = mlp.KERNEL
        kernels.update({n: getattr(mlp, a) for n, a in MLP_ENTRIES.items() if hasattr(mlp, a)})

    t0 = time.perf_counter()
    reports = cuda.build_all()
    for name, text in reports.items():
        log(f"--- nvcc {name}.cu\n{text}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "built": sorted(reports)})

    rec = Recorder()
    if "C" in phases:
        rec.wrap(algorithms, "membership_bitmask",
                 lambda kw: "membership" if kw.get("live") is None else "membership_masked",
                 shape_frequency())
        rec.wrap(algorithms, "block_candidates", "bitset")
        rec.wrap(guided_ops, "probe_batch", "guided_search")
        rec.wrap(decode_ops, "decode_batch", "plm_decode")
        rec.wrap(pfor_ops, "pfor_decode", "pfor")
        rec.wrap(bm25_ops, "score_batch", "bm25_score")
        rec.wrap(fused_ops, "fused_topk", "fused_topk", true_candidates)
        rec.wrap(dense, "dense_impl", "dense_topk")
        if "S" in phases:
            rec.wrap(algorithms, "two_tier_candidates", "two_tier", candidate_total)
        if "M" in phases:
            rec.wrap(algorithms, "mlp_membership",
                     lambda kw: "mlp_membership" if kw.get("live") is None
                     else "mlp_membership_masked", shape_frequency())
            if hasattr(algorithms, "mlp_two_tier"):
                rec.wrap(algorithms, "mlp_two_tier", "mlp_two_tier", candidate_total)
    clock = DecodeClock()
    clock.install()

    counts, passes, keep = {}, {}, {"kernels": kernels}
    p_procs = p_start(src) if "P" in phases else []
    try:
        return _run_phases(args, phases, dev, kernels, rec, clock, counts, passes, keep,
                           p_procs)
    finally:
        p_stop(p_procs)


def _run_phases(args, phases, dev, kernels, rec, clock, counts, passes, keep, p_procs) -> int:
    import torch

    from repro_torch.core import algorithms
    from repro_torch.kernels.fused_query import dense

    def launches() -> dict[str, int]:
        return {n: k.launches for n, k in kernels.items()}

    try:
        for name, run in (("A", lambda: phase_a(args, dev, launches, clock, keep)),
                          ("B", lambda: phase_b(dev, launches)),
                          ("R", lambda: phase_r(dev, launches, clock, keep)),
                          ("S", lambda: phase_s(dev, launches, clock, keep)),
                          ("Q", lambda: phase_q(dev, keep)),
                          ("M", lambda: phase_m(dev, launches, keep)),
                          ("K", lambda: phase_k(dev)),
                          ("W", lambda: phase_w(dev))):
            if name not in phases:
                continue
            for k in kernels.values():
                k.launches = 0
            dense.launches = 0
            result = run()
            if name == "W":  # row 1c leads the kernels line's membership rows
                keep["w_membership"] = result["serve_queries"]["membership"]
            counts[name] = launches()
            result["launches"] = counts[name]
            result["dense_passes"] = passes[name] = dense.launches
            emit(result)
    finally:
        if "store" in keep:  # phase S's store, which phase M serves from
            shutil.rmtree(keep["store"], ignore_errors=True)
    total = {n: sum(c[n] for c in counts.values()) for n in kernels}
    # Algorithm 3 (block) scores on membership_masked, Algorithm 1 (W's
    # exhaustive step) on membership
    missing = [n for n, c in total.items()
               if c == 0 and not (n == "membership" and "W" not in phases)]
    if missing and {"A", "B", "R"} <= phases:
        raise AssertionError(f"kernels never launched on phases A, B, R and S: {missing}")
    for phase, names in (("A", ("membership_masked", "bitset", "pfor")),
                         ("B", ("guided_search", "plm_decode")),
                         ("R", ("pfor", "bm25_score", "fused_topk", "dense_topk")),
                         ("S", ("membership_masked", "bitset", "pfor", "bm25_score", "two_tier")),
                         ("Q", ("membership_masked", "bitset", "bm25_score")),
                         ("M", ("mlp_membership", "mlp_membership_masked", "mlp_two_tier",
                                "bitset", "pfor")),
                         ("K", ("membership_masked", "bitset")),
                         ("W", ("membership", "bitset"))):
        for n in names:
            if phase in counts and n in counts[phase] and counts[phase][n] == 0:
                raise AssertionError(f"{n} did not launch on its path (phase {phase})")

    if "D" in phases:
        emit(phase_d(dev, keep))
    rows = phase_c(rec, total, keep) if "C" in phases else None
    if rows is not None and "w_membership" in keep:
        rows.insert(0, {**keep["w_membership"], "launches": total["membership"]})
    if "A" in phases:
        # after phase C, which holds membership at its most launched shape:
        # the Recorder sees these calls, all at phase A's K=1 shape
        emit(block_step(algorithms, kernels, keep))
    if rows is not None:
        emit({"phase": "C", "kernels": [r["name"] for r in rows], "launches": total})
        emit({"phase": "C_dense", "rows": [r for r in rows if r["name"] == "dense_topk"],
              "dense_passes": sum(passes.values())})
    if {"L", "G", "E", "P", "T", "X"} & phases:
        # the earlier phases' engines and kept inputs leave the card first
        keep.clear()
        for kept in (rec.inputs, rec.kwargs, rec.second):
            kept.clear()
    for name, run in (("L", phase_l), ("G", phase_g), ("E", phase_e),
                      ("P", lambda d: phase_p(d, p_procs)), ("T", phase_t), ("X", phase_x)):
        if name not in phases:
            continue
        _free()
        before, dense_before = launches(), dense.launches
        result = run(dev)
        result["launches"] = {n: c - before[n] for n, c in launches().items()}
        result["dense_passes"] = dense.launches - dense_before
        # the reference computes these paths in XLA ops: no kernel of the repo is on them
        # (phase X's ranks assert their own counts)
        assert not any(result["launches"].values()) and not result["dense_passes"], result
        emit(result)
    if rows is not None:
        emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
