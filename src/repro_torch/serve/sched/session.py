"""Session: the continuous-batching serving front-end.

``Session`` is the one front door to the serving stack — the unified API
the ROADMAP's "throughput serving" item asked for:

    requests ──> admission ──> queue ──> coalesce ──> per-shard dispatch
                 (tenant        │         (continuous   (replica groups,
                  quota,        │          batching:     least-loaded,
                  bound,        │          same-mode,    retry-once)
                  shed)         │          ≤ max_batch)       │
                                │                             ▼
                 deadline shed ─┘                      merge + resolve

One scheduler thread drains the admission queue (sched/admission.py) into
coalesced same-mode batches; batch *execution* runs on a small runner pool
(`max(1, n_replicas)` slots) so that with process replicas multiple batches
are in flight at once — while a batch executes, new arrivals pile up, and
the next dispatch is a bigger batch.  That is continuous batching: device-
sized per-shard batches form from whatever has arrived, with no fixed batch
boundary and no closed-loop barrier.

Within a batch the dispatch is the planner/executor seam from the sharded
refactor: every shard's replica group gets the whole padded batch, plans it
locally with *global* document frequencies (identical term order and
routes), and returns packed bitmaps (Boolean) or local top-k heaps
(ranked); the session word-copies bitmaps by doc offset and folds heaps
with the same ``select_topk`` the engine facade uses — so every path stays
bit-identical to the legacy ``query_*`` entry points, which survive here as
thin wrappers over ``submit``.

Every decision is observable: ``sched.*`` counters/histograms land in the
engine's metrics registry and enqueue/queue-wait/batch/dispatch/merge spans
ride the engine's tracer (repro_torch.obs), so BENCH artifacts explain themselves.
With process replicas the trace is *distributed*: a TraceContext travels
with each fan-out, workers ship their span buffers and probe records back
with the response, and replicas collate them onto the host timeline in
their own pid lanes (obs/collate.py) — one request renders end-to-end from
admission wait to worker probe/decode/kernel to merge.  Per-request
``QueryResult.autopsy()`` decomposes latency into queue/dispatch/execute/
merge, and ``slo_report()`` summarizes per-tenant deadline-hit-rate, p99
and burn-rate over a rolling window (obs/slo.py).

On a CUDA engine every process replica serves on the card: the session
builds the kernels (``kernels/cuda.build_all``) before it spawns any
worker, so K workers starting together load the libraries instead of each
running nvcc, and hands each worker its shard's slice of the model as
numpy arrays (no CUDA tensor crosses a pipe).
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from repro_torch.obs import trace
from repro_torch.obs.slo import SLOMonitor
from repro_torch.obs.trace import Span, TraceContext
from repro_torch.rank.score import TopKResult, select_topk
from repro_torch.serve.sched.admission import AdmissionQueue, Pending
from repro_torch.serve.sched.api import (
    MODE_BOOLEAN,
    MODE_RANKED,
    REJECT_SHUTDOWN,
    REJECT_WORKER_FAILED,
    QueryRequest,
    QueryResult,
    Rejected,
    WorkerFailure,
)
from repro_torch.serve.sched.replica import InlineReplica, ProcessReplica, ReplicaGroup
from repro_torch.serve.shard import WORD_BITS, pack_ids, unpack_row


def _numpy(t) -> np.ndarray:
    """A model tensor as a CPU numpy array (what a worker spec pickles)."""
    return t.detach().cpu().numpy()


class Session:
    """Continuous-batching front-end over a ``BooleanEngine`` (see module doc).

    ``store_dir`` is required when ``cfg.sched.n_replicas > 0``: process
    replicas rebuild their engines from the persistent shard-store (saved
    there on first use if absent).  ``replica_groups`` injects prebuilt
    groups (tests).  Use as a context manager, or call ``close()``.
    """

    def __init__(
        self,
        engine,
        *,
        store_dir: str | None = None,
        replica_groups: list[ReplicaGroup] | None = None,
        auto_start: bool = True,
    ):
        self.engine = engine
        self.cfg = engine.cfg
        self.sched_cfg = engine.cfg.sched
        self.metrics = engine.metrics
        self.n_docs = engine.n_docs
        self._closed = False
        self._queue = AdmissionQueue(self.sched_cfg, self.metrics)
        self._batches = self.metrics.counter("sched.batches")
        self._dispatched = self.metrics.counter("sched.dispatched")
        self._short_circuit = self.metrics.counter("sched.short_circuit")
        self._batch_size = self.metrics.histogram("sched.batch_size")
        self._queue_us = self.metrics.histogram("sched.queue_us")
        self._service_us = self.metrics.histogram("sched.service_us")
        self._dispatch_us = self.metrics.histogram("sched.dispatch_us")
        self._execute_us = self.metrics.histogram("sched.execute_us")
        self._merge_us = self.metrics.histogram("sched.merge_us")
        self.slo = self.cfg.obs.slo if self.cfg.obs.slo is not None else SLOMonitor()
        self._trace_seq = itertools.count(1)  # trace ids for worker IPC
        self._store_dir = store_dir  # warm-snapshot home
        self._groups = (
            replica_groups
            if replica_groups is not None
            else self._build_groups(store_dir)
        )
        # 2x the replica count so batch N+1 plans/merges while batch N is in
        # the workers (the replicas' own locks serialize actual execution)
        slots = 2 * max(1, self.sched_cfg.n_replicas)
        self._slots = threading.Semaphore(slots)
        self._runners = ThreadPoolExecutor(slots, thread_name_prefix="sched-run")
        # per-shard dispatch inside one batch: calls block in pipe recv (GIL
        # released), so threads here fan process replicas out for real
        self._fan = ThreadPoolExecutor(
            max(1, len(self._groups)) * slots, thread_name_prefix="sched-fan"
        )
        self._loop_thread = threading.Thread(
            target=self._loop, name="sched-loop", daemon=True
        )
        if auto_start:
            self._loop_thread.start()

    # --------------------------------------------------------------- setup
    def _build_groups(self, store_dir: str | None) -> list[ReplicaGroup]:
        eng, sc = self.engine, self.sched_cfg
        if sc.n_replicas <= 0:
            return [
                ReplicaGroup(
                    sh.shard_id,
                    [InlineReplica(sh, eng._global_dfs, eng.cfg)],
                    lo=sh.lo,
                    n_docs=sh.n_docs,
                    retries=sc.worker_retries,
                    metrics=self.metrics,
                    obs=eng.cfg.obs,
                )
                for sh in eng.shards
            ]
        if store_dir is None:
            raise ValueError(
                "process replicas (sched.n_replicas > 0) rebuild engines from "
                "the persistent shard-store: pass Session(engine, store_dir=...)"
            )
        if not os.path.exists(os.path.join(store_dir, "shards.json")):
            eng.save(store_dir)
        model = eng.lb.model
        term_table, doc_table = _numpy(model.term_embed.weight), _numpy(model.doc_embed.weight)
        bias, tau = _numpy(model.bias), _numpy(eng.lb.tau)
        mlp = [{k: _numpy(v) for k, v in layer.items()} for layer in model.head_layers()]
        global_dfs = np.asarray(eng._global_dfs)
        if eng.lb.device.type == "cuda":
            from repro_torch.kernels import cuda

            cuda.build_all()  # once, here: workers then only load the libraries
        snapshot = self._load_warm_snapshot(store_dir) if sc.warm_snapshot else None
        groups = []
        for idx, ((lo, hi), sh) in enumerate(zip(eng._ranges, eng._shards)):
            if sh is None:
                continue
            spec = {
                "store_dir": store_dir,
                "shard_idx": idx,
                "lo": lo,
                "hi": hi,
                "term_table": term_table,
                "doc_table": doc_table[lo:hi],
                "bias": bias,
                "mlp": mlp,
                "tau": tau,
                "li_cfg": eng.li_cfg,
                "cfg_kwargs": eng.cfg.worker_spec(),
                "global_dfs": global_dfs,
            }
            replicas = [
                ProcessReplica(
                    spec,
                    spawn_timeout_s=sc.spawn_timeout_s,
                    obs=eng.cfg.obs,
                    label=f"shard{idx}/replica{j}",
                    record_warm=sc.warm_snapshot,
                )
                for j in range(sc.n_replicas)
            ]
            if snapshot:
                for r in replicas:
                    r.preload_warm(snapshot)
            groups.append(
                ReplicaGroup(
                    idx,
                    replicas,
                    lo=lo,
                    n_docs=hi - lo,
                    retries=sc.worker_retries,
                    metrics=self.metrics,
                    obs=eng.cfg.obs,
                )
            )
        return groups

    @staticmethod
    def _load_warm_snapshot(store_dir: str) -> list | None:
        path = os.path.join(store_dir, "warm_snapshot.json")
        try:
            with open(path) as f:
                data = json.load(f)
            entries = data.get("entries")
            return entries or None
        except (OSError, ValueError):
            return None

    def save_warm_snapshot(self) -> str | None:
        """Persist the replicas' recorded warm traffic to the shard-store.

        ``warm_snapshot.json`` holds one representative message per dispatch
        shape any replica served; a *future* session over the same store
        preloads it into fresh replicas, whose first spawn then replays the
        previous run's shapes — warm across worker restarts *and* session
        restarts.
        """
        if self._store_dir is None:
            return None
        merged: dict = {}
        for g in self._groups:
            for r in g.replicas:
                if isinstance(r, ProcessReplica):
                    for e in r.export_warm():
                        merged[json.dumps(e, sort_keys=True)] = e
        if not merged:
            return None
        path = os.path.join(self._store_dir, "warm_snapshot.json")
        with open(path, "w") as f:
            json.dump({"version": 1, "entries": list(merged.values())}, f)
        return path

    def warm(self) -> None:
        """Force-spawn every process replica and serve each batch shape once.

        Dispatch pads Boolean batches to power-of-two buckets (``_bucket``);
        serving each bucket once here keeps every first-use cost (the
        worker's CUDA context, its kernels' first launches, its stream
        arena's upload) out of the serving path.
        """
        replicas = [r for g in self._groups for r in g.replicas]
        futs = [self._fan.submit(r.call, ("ping",)) for r in replicas]
        for f in futs:
            assert f.result() == "pong"
        # one live term so the probe phase actually runs (all-pad batches
        # short-circuit before the candidate step)
        t = int(np.argmax(self.engine._global_dfs))
        b = 1
        while True:
            q = np.full((b, self.cfg.max_query_terms), -1, dtype=np.int32)
            q[:, 0] = t
            futs = [self._fan.submit(r.call, ("bool", q)) for r in replicas]
            for f in futs:
                f.result()
            if b >= self.sched_cfg.max_batch:
                break
            b = min(2 * b, self.sched_cfg.max_batch)
        if self.cfg.ranked.enabled and self.cfg.ranked.fused_kernel:
            self._warm_fused(replicas, t)
        if self.sched_cfg.warm_snapshot and self.sched_cfg.n_replicas > 0:
            self.save_warm_snapshot()

    def _warm_fused(self, replicas, t: int) -> None:
        """Serve the fused ranked path's row buckets once on every replica.

        Driving the power-of-two row buckets with real terms uploads the
        dense arena and runs the dense pass's shapes outside the serving
        path, as the boolean warm above does.  Best-effort: a store without
        payload streams can't rank, so failures leave the replica cold, not
        broken.
        """
        # several dense terms at k=1: the threshold rises after the first
        # essential decode, leaving the rest as a probe tail for the kernel
        dfs = np.asarray(self.engine._global_dfs)
        terms = tuple(int(x) for x in np.argsort(dfs)[-4:] if dfs[x] > 0) or (t,)
        item = (terms, (), 1, 0)
        b = 1
        while True:
            futs = [
                self._fan.submit(r.call, ("topk", [item] * b)) for r in replicas
            ]
            try:
                for f in futs:
                    f.result()
            except Exception:
                return
            if b >= self.sched_cfg.max_batch:
                return
            b = min(2 * b, self.sched_cfg.max_batch)

    @staticmethod
    def _bucket(n: int) -> int:
        """Round a batch size up to a power of two: a handful of padded
        shapes (the reference's jit buckets) instead of one per batch size."""
        b = 1
        while b < n:
            b *= 2
        return b

    # -------------------------------------------------------------- submit
    def submit_async(self, req: QueryRequest, *, block: bool = False) -> Future:
        """Admit one request; the future resolves to QueryResult | Rejected.

        ``block=True`` waits for queue space instead of shedding on a full
        queue (the legacy sync wrappers' backpressure).  Never blocks on
        execution — that is the future's job.
        """
        fut: Future = Future()
        t_submit = time.monotonic()
        if self._closed:
            self._slo_track(fut, req.tenant, t_submit, None)
            fut.set_result(Rejected(reason=REJECT_SHUTDOWN, tenant=req.tenant))
            return fut
        row = req.terms
        if len(row) < self.cfg.max_query_terms:
            row = np.pad(
                row, (0, self.cfg.max_query_terms - len(row)), constant_values=-1
            )
        # all-pad / k<=0 short-circuit: resolved here, never queued, exactly
        # like the engine facade's empty-batch path
        if (row < 0).all() or (req.mode == MODE_RANKED and req.k <= 0):
            self._short_circuit.inc()
            self._slo_track(fut, req.tenant, t_submit, None)
            fut.set_result(self._empty_result(req))
            return fut
        deadline_ms = (
            req.deadline_ms
            if req.deadline_ms is not None
            else self.sched_cfg.default_deadline_ms
        )
        pending = Pending(
            req=req,
            future=fut,
            row=row,
            t_submit=t_submit,
            deadline=(
                t_submit + deadline_ms / 1e3 if deadline_ms is not None else None
            ),
        )
        self._slo_track(fut, req.tenant, t_submit, pending.deadline)
        with trace.activate(self.cfg.obs.trace), trace.span(
            "sched.enqueue", mode=req.mode, tenant=req.tenant, priority=req.priority
        ):
            self._queue.offer(pending, block=block)
        return fut

    def _slo_track(
        self, fut: Future, tenant: str, t_submit: float, deadline: float | None
    ) -> None:
        """Feed the SLO window when the future resolves — served or shed,
        every admitted outcome is one sample (shed never meets a deadline)."""

        def cb(f: Future) -> None:
            r = f.result()  # resolved by contract before callbacks fire
            now = time.monotonic()
            served = bool(r.ok)
            met = served and (deadline is None or now <= deadline)
            self.slo.record(
                tenant,
                latency_us=1e6 * (now - t_submit),
                served=served,
                deadline_met=met,
            )

        fut.add_done_callback(cb)

    def submit(self, req: QueryRequest, *, timeout: float | None = None):
        """Synchronous submit: block until served or shed."""
        return self.submit_async(req, block=True).result(timeout)

    def _empty_result(self, req: QueryRequest) -> QueryResult:
        scores = np.zeros(0, np.int64) if req.mode == MODE_RANKED else None
        return QueryResult(ids=np.zeros(0, np.int32), scores=scores)

    # ---------------------------------------------------------------- loop
    def _loop(self) -> None:
        while True:
            # claim a runner slot *before* popping work: while every slot is
            # busy, arrivals keep coalescing in the queue instead of being
            # pinned inside an already-popped batch that is stuck waiting
            # for a runner
            self._slots.acquire()
            batch = self._queue.take_batch(self.sched_cfg.max_batch)
            if not batch:
                self._slots.release()
                if self._closed:
                    return
                continue
            self._runners.submit(self._run_batch, batch)

    def _run_batch(self, batch: list[Pending]) -> None:
        t0 = time.monotonic()
        mode = batch[0].req.mode
        for p in batch:
            self._queue_us.observe(1e6 * (t0 - p.t_submit))
        self._queue_wait_spans(batch, t0)
        self._batches.inc()
        self._batch_size.observe(len(batch))
        self._dispatched.inc(len(batch))
        try:
            with trace.activate(self.cfg.obs.trace), trace.span(
                "sched.batch", mode=mode, size=len(batch)
            ):
                if mode == MODE_BOOLEAN:
                    self._run_boolean(batch, t0)
                else:
                    self._run_ranked(batch, t0)
        except WorkerFailure as e:
            for p in batch:
                p.reject(REJECT_WORKER_FAILED, detail=str(e))
        except Exception as e:  # never leave an admitted future hanging
            for p in batch:
                p.reject(REJECT_WORKER_FAILED, detail=repr(e))
        finally:
            self._service_us.observe(1e6 * (time.monotonic() - t0))
            self._slots.release()

    def _queue_wait_spans(self, batch: list[Pending], t0: float) -> None:
        """Retroactive admission-wait spans: submit -> dispatch per request.

        ``time.monotonic`` and ``perf_counter`` share CLOCK_MONOTONIC on
        Linux, so the wait interval maps onto the tracer's timeline exactly;
        recorded at dispatch because only then is the wait's end known.
        Each wait gets a lane of its own (tid ``-1 - seq``): on the runner
        thread's lane, where the reference records it, a request that waited
        while that thread ran an earlier batch partially overlaps that
        batch's spans, and the trace fails the nesting invariant.
        """
        tracer = self.cfg.obs.trace
        if tracer is None:
            return
        now_us = (time.perf_counter_ns() - tracer.epoch_ns) / 1e3
        for p in batch:
            tid = -1 - p.seq
            dur_us = 1e6 * (t0 - p.t_submit)
            tracer.add_span(
                Span(
                    name="sched.queue_wait",
                    ts_us=now_us - dur_us,
                    dur_us=dur_us,
                    tid=tid,
                    depth=0,
                    attrs={"tenant": p.req.tenant, "mode": p.req.mode},
                )
            )

    def _stack_rows(self, batch: list[Pending], pad_rows: bool = False) -> np.ndarray:
        width = max(len(p.row) for p in batch)
        rows = self._bucket(len(batch)) if pad_rows else len(batch)
        q = np.full((rows, width), -1, dtype=np.int32)
        for j, p in enumerate(batch):
            q[j, : len(p.row)] = p.row
        return q

    def _fan_out(self, msg) -> list:
        """One message to every shard group, in parallel when it pays.

        Appends a ``TraceContext`` telling workers what telemetry to ship
        back (None when nothing is listening, so the trace-off wire cost
        stays zero); inline replicas ignore the extra element.
        """
        msg = msg + (self._trace_ctx(),)
        if len(self._groups) == 1:
            return [self._groups[0].call(msg)]
        futs = [self._fan.submit(g.call, msg) for g in self._groups]
        return [f.result() for f in futs]  # re-raises WorkerFailure

    def _trace_ctx(self):
        obs = self.cfg.obs
        if obs.trace is None and obs.probe_log is None:
            return None
        return TraceContext(
            trace_id=next(self._trace_seq),
            trace=obs.trace is not None,
            probe=obs.probe_log is not None,
        )

    def _ranked_forward_floors(self, batch, items, idxmap) -> list:
        """Ranked fan-in with the global kth-score floor θ forwarded.

        Groups run *sequentially* in ascending doc-range order; each later
        group's items carry the merged running heap's kth score as a strict
        floor, so its shards stop scoring candidates the global top-k
        already excludes (shard heaps prune globally instead of
        independently — the K>1 scored_fraction satellite).  Doc ranges
        ascend and ties break by ascending id, so a later shard's tie can
        never displace the heap: results stay bit-identical to the
        concurrent floor-0 fan-out, which tests assert.
        """
        order = sorted(range(len(self._groups)), key=lambda g: self._groups[g].lo)
        heaps: list = [None] * len(items)
        for g in order:
            group = self._groups[g]
            sent = []
            for n, (terms, req, k, _) in enumerate(items):
                h = heaps[n]
                floor = int(h.scores[k - 1]) if h is not None and len(h.scores) == k else 0
                sent.append((terms, req, k, floor))
            part = group.call(("topk", sent, self._trace_ctx()))
            for n, (terms, req, k, _) in enumerate(items):
                ids, scores = part[n]
                if len(ids) == 0:
                    continue
                h = heaps[n]
                if h is None:
                    heaps[n] = select_topk(ids, scores, k)
                else:
                    heaps[n] = select_topk(
                        np.concatenate([h.ids, ids]),
                        np.concatenate([h.scores, scores]),
                        k,
                    )
        empty = TopKResult(ids=np.zeros(0, np.int32), scores=np.zeros(0, np.int64))
        return [h if h is not None else empty for h in heaps]

    def _timing(self, p: Pending, t0: float, phases: dict | None = None) -> dict:
        return {
            "queue_us": 1e6 * (t0 - p.t_submit),
            "service_us": 1e6 * (time.monotonic() - t0),
            "phases": dict(phases) if phases else None,
        }

    def _phase_marks(self, t0: float, t_x0: float, t_x1: float) -> dict:
        """The batch's service decomposition (one dict shared per batch):
        dispatch = stack/plan before the fan-out, execute = fan-out wall,
        merge = everything after (fold + resolve).  Feeds QueryResult.autopsy
        and the sched.dispatch_us/execute_us/merge_us histograms."""
        t_m = time.monotonic()
        phases = {
            "dispatch_us": 1e6 * (t_x0 - t0),
            "execute_us": 1e6 * (t_x1 - t_x0),
            "merge_us": 1e6 * (t_m - t_x1),
        }
        self._dispatch_us.observe(phases["dispatch_us"])
        self._execute_us.observe(phases["execute_us"])
        self._merge_us.observe(phases["merge_us"])
        return phases

    def _run_boolean(self, batch: list[Pending], t0: float) -> None:
        q = self._stack_rows(batch, pad_rows=True)  # bucketed probe shape
        t_x0 = time.monotonic()
        with trace.span("sched.dispatch", shards=len(self._groups), size=len(batch)):
            parts = self._fan_out(("bool", q))
        t_x1 = time.monotonic()
        words = (self.n_docs + WORD_BITS - 1) // WORD_BITS
        merged = np.zeros((len(batch), words), dtype=np.uint32)
        with trace.span("sched.merge"):
            for g, bm in zip(self._groups, parts):
                off = g.lo // WORD_BITS
                merged[:, off : off + bm.shape[1]] = bm[: len(batch)]
        phases = self._phase_marks(t0, t_x0, t_x1)
        for j, p in enumerate(batch):
            p.resolve(
                QueryResult(
                    ids=unpack_row(merged[j], self.n_docs),
                    **self._timing(p, t0, phases),
                )
            )

    def _run_ranked(self, batch: list[Pending], t0: float) -> None:
        from repro_torch.serve.planner import plan_ranked

        q = self._stack_rows(batch)
        required = np.zeros(q.shape, dtype=bool)
        for j, p in enumerate(batch):
            if p.req.required is not None:
                required[j, : len(p.req.required)] = p.req.required
        qplans = plan_ranked(q, self.engine._global_dfs, mode="or", required=required)
        items, idxmap = [], []
        for j, (p, qp) in enumerate(zip(batch, qplans)):
            if qp.dead:
                p.resolve(
                    QueryResult(
                        ids=np.zeros(0, np.int32),
                        scores=np.zeros(0, np.int64),
                        **self._timing(p, t0),
                    )
                )
                continue
            # floor=0 placeholder: _ranked_forward_floors rewrites it per
            # group when SchedConfig.forward_floor shares the running global
            # kth score across the fan-in (exactness never depends on it —
            # shard heaps merge associatively — it only skips work)
            items.append((qp.terms, qp.required, int(p.req.k), 0))
            idxmap.append(j)
        if not items:
            return
        forward = self.sched_cfg.forward_floor and len(self._groups) > 1
        t_x0 = time.monotonic()
        with trace.span("sched.dispatch", shards=len(self._groups), size=len(items)):
            if forward:
                tops = self._ranked_forward_floors(batch, items, idxmap)
            else:
                parts = self._fan_out(("topk", items))
        t_x1 = time.monotonic()
        with trace.span("sched.merge"):
            if not forward:
                tops = []
                for n, j in enumerate(idxmap):
                    p = batch[j]
                    ids = np.concatenate([part[n][0] for part in parts])
                    scores = np.concatenate([part[n][1] for part in parts])
                    tops.append(select_topk(ids, scores, int(p.req.k)))
        phases = self._phase_marks(t0, t_x0, t_x1)
        for top, j in zip(tops, idxmap):
            p = batch[j]
            p.resolve(
                QueryResult(
                    ids=top.ids, scores=top.scores, **self._timing(p, t0, phases)
                )
            )

    # ----------------------------------------------------- legacy wrappers
    def query_batch(self, queries: np.ndarray) -> list[np.ndarray]:
        """Legacy entry point: (Q, T) padded term ids -> per-query doc ids.

        A thin wrapper over ``submit`` — every row becomes one boolean
        ``QueryRequest`` (blocking admission, no deadline), results are
        bit-identical to ``BooleanEngine.query_batch``.
        """
        rows = self._rows(queries)
        futs = [
            self.submit_async(QueryRequest(terms=row), block=True) for row in rows
        ]
        return [self._unwrap(f).ids for f in futs]

    def query_batch_bitmap(self, queries: np.ndarray) -> np.ndarray:
        """Legacy entry point: (Q, T) -> (Q, ceil(n_docs/32)) packed uint32."""
        rows = self._rows(queries)
        words = (self.n_docs + WORD_BITS - 1) // WORD_BITS
        out = np.zeros((len(rows), words), dtype=np.uint32)
        futs = [
            self.submit_async(QueryRequest(terms=row), block=True) for row in rows
        ]
        for j, f in enumerate(futs):
            out[j] = pack_ids(self._unwrap(f).ids, self.n_docs)
        return out

    def query_topk(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        mode: str = "or",
        required: np.ndarray | None = None,
    ) -> list[TopKResult]:
        """Legacy entry point: ranked top-k, bit-identical to the facade."""
        if mode not in ("or", "and"):
            raise ValueError(f"mode must be 'or' or 'and', got {mode!r}")
        rows = self._rows(queries)
        futs = []
        for j, row in enumerate(rows):
            if required is not None:
                req_mask = np.asarray(required[j], dtype=bool)
            elif mode == "and":
                req_mask = row >= 0
            else:
                req_mask = None
            futs.append(
                self.submit_async(
                    QueryRequest(terms=row, mode=MODE_RANKED, k=k, required=req_mask),
                    block=True,
                )
            )
        return [
            TopKResult(ids=r.ids, scores=r.scores)
            for r in (self._unwrap(f) for f in futs)
        ]

    def _rows(self, queries: np.ndarray) -> list[np.ndarray]:
        q = np.asarray(queries, dtype=np.int32)
        if q.ndim != 2:
            raise ValueError(f"queries must be (Q, T), got shape {q.shape}")
        return [q[i] for i in range(q.shape[0])]

    def _unwrap(self, fut: Future) -> QueryResult:
        r = fut.result()
        if not r.ok:
            raise RuntimeError(f"request shed: {r.reason} ({r.detail})")
        return r

    # ------------------------------------------------------------------ slo
    def slo_report(self) -> dict:
        """Rolling SLO view: per-tenant deadline-hit-rate / p99 / burn-rate
        (obs/slo.py sliding window) paired with the whole-process ``sched.*``
        latency histograms from the metrics registry."""
        sched = self.metrics.snapshot().get("sched", {})
        keep = (
            "queue_us",
            "service_us",
            "dispatch_us",
            "execute_us",
            "merge_us",
            "batch_size",
            "shed",
        )
        return {
            "window_s": self.slo.window_s,
            "target": self.slo.target,
            "tenants": self.slo.report(),
            "sched": {k: sched[k] for k in keep if k in sched},
        }

    # ---------------------------------------------------------------- exit
    def close(self) -> None:
        """Shed the queue (typed ``Rejected("shutdown")``), stop replicas."""
        if self._closed:
            return
        self._closed = True
        self._queue.close()
        if self._loop_thread.is_alive():
            self._loop_thread.join(timeout=5.0)
        self._runners.shutdown(wait=True)
        self._fan.shutdown(wait=True)
        for g in self._groups:
            g.close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
