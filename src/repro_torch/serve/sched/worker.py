"""Process shard worker: one ShardEngine served over a multiprocessing pipe.

The GIL is why the serving front-end sheds threads for processes: the
probe/verify phase is many small numpy calls, and threads convoy on it.  A
process replica owns a full ``ShardEngine`` for one document partition,
rebuilt from the persistent shard-store (``index/store.py``, the layout
``BooleanEngine.save`` writes) — streams are ``np.memmap`` arenas, so R
replicas of a shard share one page cache and none of them re-encodes
anything.  On a CUDA engine each worker owns a CUDA context and its shard's
device tables, and launches the port's kernels itself; the libraries were
built by the parent before it spawned any worker (``kernels/cuda.py``), so
a worker only loads them.  A worker whose launch fails answers ``("err",
traceback)``; nothing carries on on the CPU.

Protocol (request/response over one ``multiprocessing.Pipe``):

  ("ready", {"shard": i, "pid": p, "seconds": {...}})
                                  worker -> parent once the engine is built;
                                  ``seconds`` holds the device init (the CUDA
                                  context on a card) and the shard's rebuild
                                  from the store
  ("bool", q[, ctx])              (B, T) padded int32 -> ("ok", packed bitmap)
  ("topk", [(terms, required, k, floor), ...][, ctx])
                                  -> ("ok", [(ids, scores), ...]) global ids
  ("ping",)                       -> ("ok", "pong") — forces spawn/warm
  ("clock",)                      -> ("ok", perf_counter_ns) — offset sync
  ("stats",)                      -> ("ok", shard metrics snapshot)
  ("caches",)                     -> ("ok", cache_report) — dense-pass shape
                                  count, observed dense shapes and arena
                                  counters; the warm-snapshot tests read this
                                  to prove a respawned worker needs nothing
                                  new
  ("crash",)                      hard-exits the process (crash-path tests)
  ("stop",)                       clean shutdown
  ("err", traceback_str)          any handler failure (worker stays alive)

The reference's worker points JAX's persistent compilation cache at the
store before it builds its engine; the port has no counterpart: its kernels
are shared libraries, built once, and the spec's ``cfg_kwargs`` carry no
cache directory.

``ctx`` is an optional ``repro_torch.obs.TraceContext``: when present the
reply grows a third element, ``("ok", payload, {"spans": [...], "probes":
[...]})`` — the worker's span buffer (drained per request, absolute
worker-clock nanoseconds) and its routed-probe records, which the host
replica maps onto its own timeline / probe sink (obs/collate.py).  The
worker runs its own ``Tracer`` and an in-memory ``ProbeLog`` either way;
with no ctx (or ``ctx.trace`` false) nothing extra is recorded or shipped.

Workers plan locally: each carries the *global* document frequencies, so
``plan_batch`` on a worker reproduces the facade plan for its shard exactly
— term order, run masks and guided/decode routes are identical, which is
what keeps the process-parallel path bit-identical to in-process serving.

The spec carries numpy arrays and the device string, never a CUDA tensor
(a CUDA IPC handle would tie the worker to its parent's allocations): the
shard's slice of the membership model (term table, its rows of the doc
table, bias, and the MLP head's layers where the model has one), the
thresholds and the global dfs.

``execute_bool`` / ``execute_topk`` are shared with ``InlineReplica`` so
the inline (0-replica) scheduler path runs the very same code.
"""
from __future__ import annotations

import os
import time
import traceback

import numpy as np

from repro_torch.obs import trace


def execute_bool(shard, q: np.ndarray, global_dfs: np.ndarray, verified: bool) -> np.ndarray:
    """Plan (global term order) + execute one shard's slice of a batch."""
    from repro_torch.serve.planner import plan_batch

    plan = plan_batch(q, global_dfs, [shard], verified=verified)
    return shard.execute(q, plan.shard_plans[0], plan.qplans)


def execute_topk(shard, items: list) -> list:
    """Serve [(terms, required, k, floor)] -> [(global ids, scores)].

    Applies the ranked run mask locally (skip when no term has local
    postings or a required term is absent — same rule as
    planner.ranked_run_mask), so the session can broadcast one item list to
    every shard group.  Live items go through ``shard.query_topk_batch`` in
    one call (fused_topk launches with ``ranked.fused_kernel``, else
    multi-phase MaxScore with one prefetch and, with ``score_kernel``, one
    bm25_score launch).
    """
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int64))
    ldfs = shard.local_dfs
    out: list = [empty] * len(items)
    idx, batch = [], []
    for pos, (terms, required, k, floor) in enumerate(items):
        terms = tuple(int(t) for t in terms)
        required = tuple(int(t) for t in required)
        if (
            not terms
            or k <= 0
            or not any(int(ldfs[t]) for t in terms)
            or any(int(ldfs[t]) == 0 for t in required)
        ):
            continue
        idx.append(pos)
        batch.append((terms, int(k), required, int(floor)))
    if batch:
        for pos, r in zip(idx, shard.query_topk_batch(batch)):
            out[pos] = (r.ids, r.scores)
    return out


def cache_report(shard) -> dict:
    """Dense-pass census for one engine: the warm-restore probe.

    ``dense_cache`` / ``dense_shapes`` are the dense-pass shapes *this*
    process has run (``kernels.fused_query.dense.cache_size``); ``arena`` is
    the device-arena residency counters (uploads must stay at 1 per process
    no matter how many passes ran).  Inline replicas report the same shape.
    """
    from repro_torch.kernels.fused_query import dense

    arena = getattr(getattr(shard, "_ranked", None), "_arena", None) or None
    return {
        "dense_cache": dense.cache_size(),
        "dense_shapes": sorted(dense.observed_shapes()),
        "arena": arena.counters.as_dict() if arena else None,
    }


def _build_shard(spec: dict, seconds: dict):
    """Reconstruct the spec'd ShardEngine from the persistent shard-store;
    ``seconds`` gets the device-init and rebuild times."""
    import torch

    from repro_torch.common.device import resolve_device
    from repro_torch.core.learned_bloom import LearnedBloom
    from repro_torch.core.membership import MembershipModel
    from repro_torch.index.store import load_index
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.shard import ShardEngine

    t0 = time.perf_counter()
    cfg = ServeConfig(**spec["cfg_kwargs"])
    dev = resolve_device(cfg.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # replicas, not intra-op threads, are the parallelism
    torch.zeros(1, device=dev)  # the device's context, created here, not at the first batch
    seconds["device_init"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    lo, hi = int(spec["lo"]), int(spec["hi"])
    lb = LearnedBloom(
        model=MembershipModel(tensor(spec["term_table"]), tensor(spec["doc_table"]),
                              tensor(spec["bias"]),
                              [{k: tensor(v) for k, v in layer.items()} for layer in spec["mlp"]]),
        tau=tensor(spec["tau"]),
        n_docs=hi - lo,
    )
    inv, store = load_index(
        os.path.join(spec["store_dir"], f"shard-{spec['shard_idx']:04d}"), mmap=True
    )
    shard = ShardEngine(lb, inv, spec["li_cfg"], cfg, lo=lo, hi=hi, tier2=store)
    shard.shard_id = int(spec["shard_idx"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds["rebuild"] = time.perf_counter() - t0
    return shard, cfg


def worker_main(conn, spec: dict) -> None:
    """Entry point of a spawned process replica (see module docstring)."""
    from repro_torch.obs.probelog import ProbeLog
    from repro_torch.obs.trace import Tracer

    try:
        seconds: dict[str, float] = {}
        shard, cfg = _build_shard(spec, seconds)
        # in-memory probe sink, installed before the engine's first probe
        # (GuidedPostings captures the handle lazily); drained per request
        # and shipped back when the ctx asks, discarded otherwise
        plog = ProbeLog()
        cfg.obs.probe_log = plog
        wtracer = Tracer(name=f"shard-worker-{spec['shard_idx']}")
        global_dfs = np.asarray(spec["global_dfs"])
        conn.send(("ready", {"shard": int(spec["shard_idx"]), "pid": os.getpid(),
                             "seconds": seconds}))
    except Exception:
        try:
            conn.send(("err", traceback.format_exc()))
        finally:
            return
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        op = msg[0]
        if op == "stop":
            return
        if op == "crash":  # test hook: die mid-batch, no reply, no cleanup
            os._exit(17)
        try:
            if op == "ping":
                conn.send(("ok", "pong"))
            elif op == "clock":
                conn.send(("ok", time.perf_counter_ns()))
            elif op in ("bool", "topk"):
                ctx = msg[2] if len(msg) > 2 else None
                traced = ctx is not None and ctx.trace
                with trace.activate(wtracer if traced else None), trace.span(
                    f"worker.{op}", trace_id=getattr(ctx, "trace_id", 0)
                ), plog.context(query=None, shard=shard.shard_id):
                    if op == "bool":
                        payload = execute_bool(shard, msg[1], global_dfs, cfg.verified)
                    else:
                        payload = execute_topk(shard, msg[1])
                probes = plog.drain()  # drain always: bound worker memory
                if ctx is None:
                    conn.send(("ok", payload))
                else:
                    wire = {"spans": wtracer.drain_wire() if traced else []}
                    if ctx.probe:
                        wire["probes"] = probes
                    conn.send(("ok", payload, wire))
            elif op == "stats":
                conn.send(("ok", shard.metrics.snapshot()))
            elif op == "caches":
                conn.send(("ok", cache_report(shard)))
            else:
                conn.send(("err", f"unknown op {op!r}"))
        except Exception:
            try:
                conn.send(("err", traceback.format_exc()))
            except (BrokenPipeError, OSError):
                return
