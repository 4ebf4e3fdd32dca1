"""Replica groups: least-loaded dispatch over shard executors, retry-once.

A ``ReplicaGroup`` owns every executor that can serve one document
partition.  Two replica kinds implement the same two-method surface
(``call(msg)`` / ``close()`` plus an ``inflight`` load counter):

  * ``InlineReplica`` — the facade engine's own in-process ``ShardEngine``.
    The 0-replica scheduler path: no processes, no pickling, execution on
    the session's dispatch thread through the *same* ``execute_bool`` /
    ``execute_topk`` helpers the workers run.
  * ``ProcessReplica`` — a spawned worker process (sched/worker.py) holding
    its own engine over the shared mmap shard-store.  Spawn is lazy (first
    ``call``) and a replica that died is respawned on its next use, so a
    crashed worker costs one failed dispatch, not a dead shard.

``ReplicaGroup.call`` picks the least-loaded live replica (smallest
``inflight``), and on a ``ReplicaError`` retries the batch — preferring a
*different* replica — up to ``SchedConfig.worker_retries`` times before
surfacing a typed ``WorkerFailure``.  The session converts that into
``Rejected("worker_failed")`` results: a crash mid-batch is visible, typed,
and bounded, never a hang or a silent drop.

Observability rides the same seam.  After every ready handshake — first
spawn or respawn — a ``ProcessReplica`` pings the worker's monotonic clock
(obs/collate.estimate_clock_offset) so shipped span timestamps can be mapped
onto the host timeline; replies carrying a third element (the worker's span
buffer and probe records, see sched/worker.py) are ingested into the host
tracer / probe sink right where the reply lands.  ``ReplicaGroup.call``
re-activates the configured tracer around the dispatch because it often runs
on a fan-pool thread that has no ambient tracer of its own.

Warm snapshots close the respawn gap.  A fresh worker process has uploaded
nothing (its guided stream arena, its dense impact arena) and run no
dense-pass shape, so a crash used to mean the replacement pays those on
first contact.  A ``ProcessReplica`` therefore keeps a small *warm log* —
one sanitized (trace-context-stripped) representative message per
distinct dispatch shape — and replays it into every freshly spawned
process right after the ready handshake, before the replica serves its
next request, so a respawned worker is serving-warm and bit-identical from
its first real dispatch.  The log round-trips through ``Session.warm()``'s
``warm_snapshot.json`` so even a brand-new session restores the previous
run's shape coverage.  Workers are spawned, never forked: CUDA does not
survive a fork.
"""
from __future__ import annotations

import multiprocessing as mp
import threading
import time

import numpy as np

from repro_torch.obs import trace
from repro_torch.obs.collate import estimate_clock_offset, ingest_worker_spans
from repro_torch.serve.sched.api import WorkerFailure
from repro_torch.serve.sched.worker import execute_bool, execute_topk, worker_main


class ReplicaError(RuntimeError):
    """One dispatch to one replica failed (connection lost or worker error)."""


class InlineReplica:
    """In-process executor over the facade's own ShardEngine."""

    def __init__(self, shard, global_dfs, cfg):
        self._shard = shard
        self._dfs = global_dfs
        self._cfg = cfg
        self._lock = threading.Lock()  # ShardEngine state is not thread-safe
        self.inflight = 0

    def call(self, msg):
        with self._lock:
            op = msg[0]
            if op == "bool":
                return execute_bool(self._shard, msg[1], self._dfs, self._cfg.verified)
            if op == "topk":
                return execute_topk(self._shard, msg[1])
            if op == "ping":
                return "pong"
            if op == "stats":
                return self._shard.metrics.snapshot()
            if op == "caches":
                from repro_torch.serve.sched.worker import cache_report

                return cache_report(self._shard)
            raise ReplicaError(f"unknown op {op!r}")

    def close(self) -> None:
        pass


class ProcessReplica:
    """A worker process serving one shard; lazily spawned, auto-respawned.

    ``obs`` (an ObsConfig) is where shipped worker telemetry lands: spans
    into ``obs.trace`` (time-aligned via the per-spawn clock sync), probe
    records into ``obs.probe_log``.  ``label`` names the replica's process
    lane in the exported trace.
    """

    _WARM_LIMIT = 32  # distinct dispatch shapes worth replaying into a respawn

    def __init__(
        self,
        spec: dict,
        *,
        spawn_timeout_s: float = 120.0,
        obs=None,
        label: str | None = None,
        record_warm: bool = True,
    ):
        self.spec = spec
        self.spawn_timeout_s = spawn_timeout_s
        self.obs = obs
        self.label = label or f"shard{spec['shard_idx']}-worker"
        self.record_warm = record_warm
        self.inflight = 0
        self.pid: int | None = None
        self.clock_offset_ns: int | None = None  # worker clock - host clock
        self.clock_rtt_ns: int | None = None
        self.clock_syncs = 0  # one per (re)spawn; tests assert the re-sync
        self.warm_replays = 0  # entries replayed into the last (re)spawn
        # the last (re)spawn's seconds: start to ready handshake, the
        # worker's own split of it, and the warm-log replay
        self.spawn_seconds: dict[str, float] = {}
        # signature -> sanitized (ctx-stripped) message; ordered, bounded
        self._warm_log: dict = {}
        self._lock = threading.Lock()  # pipe is strict request/response
        self._proc = None
        self._conn = None

    @property
    def alive(self) -> bool:
        return self._conn is not None and self._proc is not None and self._proc.is_alive()

    def _start_locked(self) -> None:
        ctx = mp.get_context("spawn")  # CUDA does not survive fork
        t0 = time.perf_counter()
        parent, child = ctx.Pipe()
        proc = ctx.Process(
            target=worker_main, args=(child, self.spec), daemon=True,
            name=f"shard-worker-{self.spec['shard_idx']}",
        )
        proc.start()
        child.close()
        if not parent.poll(self.spawn_timeout_s):
            proc.terminate()
            raise ReplicaError(
                f"worker for shard {self.spec['shard_idx']} not ready within "
                f"{self.spawn_timeout_s}s"
            )
        tag, payload = parent.recv()
        if tag != "ready":
            proc.terminate()
            raise ReplicaError(f"worker failed to build its engine: {payload}")
        self._proc, self._conn = proc, parent
        self.pid = int(payload["pid"])
        self.spawn_seconds = {"ready": time.perf_counter() - t0, **payload.get("seconds", {})}
        self._sync_clock_locked()

    def _sync_clock_locked(self) -> None:
        """Estimate this worker's monotonic-clock offset (min-RTT pings).

        Runs after every ready handshake, so a respawned replica — a fresh
        process with a fresh clock origin — re-syncs before it serves.
        """

        def roundtrip() -> int:
            self._conn.send(("clock",))
            tag, t_worker = self._conn.recv()
            if tag != "ok":
                raise ReplicaError(f"clock sync failed: {t_worker}")
            return int(t_worker)

        self.clock_offset_ns, self.clock_rtt_ns = estimate_clock_offset(roundtrip)
        self.clock_syncs += 1

    def _fail_locked(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
        if self._proc is not None:
            self._proc.terminate()
        self._proc = self._conn = None

    def call(self, msg):
        with self._lock:
            if not self.alive:
                self._fail_locked()  # reap a dead process before respawn
                self._start_locked()
                self._replay_warm_locked()
            payload = self._roundtrip_locked(msg)
            if self.record_warm and msg[0] in ("bool", "topk"):
                self._record_warm_locked(msg)
            return payload

    def _roundtrip_locked(self, msg):
        try:
            self._conn.send(msg)
            reply = self._conn.recv()
        except (EOFError, BrokenPipeError, ConnectionResetError, OSError) as e:
            self._fail_locked()
            raise ReplicaError(f"worker connection lost: {e!r}") from e
        tag, payload = reply[0], reply[1]
        if tag == "err":  # handler error; the worker itself is still up
            raise ReplicaError(payload)
        if len(reply) > 2 and reply[2]:
            self._ingest(reply[2])
        return payload

    # ------------------------------------------------------------- warm log
    @staticmethod
    def _warm_key(msg):
        """Dispatch-shape signature of a message: the boolean batch's
        (rows, terms) shape, the ranked batch's (rows, terms, k) bucket —
        one representative message per signature covers the shapes (and
        the uploads) a worker's kernels see.
        """
        op = msg[0]
        if op == "bool":
            return ("bool",) + tuple(msg[1].shape)
        if op == "topk":
            items = msg[1]
            return (
                "topk",
                len(items),
                max((len(it[0]) for it in items), default=0),
                tuple(sorted({int(it[2]) for it in items})),
            )
        return None

    def _record_warm_locked(self, msg) -> None:
        key = self._warm_key(msg)
        if key is None:
            return
        self._warm_log.pop(key, None)
        while len(self._warm_log) >= self._WARM_LIMIT:  # evict oldest shapes
            self._warm_log.pop(next(iter(self._warm_log)))
        self._warm_log[key] = msg[:2]  # ctx stripped: replay is untraced

    def _replay_warm_locked(self) -> None:
        """Replay the warm log into a freshly spawned worker (best-effort).

        Runs after the ready handshake of every (re)spawn: the fresh
        process serves each recorded dispatch shape once, so a respawned
        replica meets its first real request with its tables uploaded and
        every dense-pass shape run.  A replay failure leaves the replica
        cold, not broken.
        """
        self.warm_replays = 0
        t0 = time.perf_counter()
        try:
            for m in list(self._warm_log.values()):
                self._roundtrip_locked(m)
                self.warm_replays += 1
        except ReplicaError:
            pass
        finally:
            self.spawn_seconds["warm_replay"] = time.perf_counter() - t0

    def export_warm(self) -> list:
        """The warm log as JSON-able entries (Session.warm snapshotting)."""
        with self._lock:
            out = []
            for m in self._warm_log.values():
                if m[0] == "bool":
                    out.append({"op": "bool", "q": np.asarray(m[1]).tolist()})
                else:
                    out.append(
                        {
                            "op": "topk",
                            "items": [
                                [
                                    [int(t) for t in terms],
                                    [int(t) for t in required],
                                    int(k),
                                    int(floor),
                                ]
                                for terms, required, k, floor in m[1]
                            ],
                        }
                    )
            return out

    def preload_warm(self, entries: list) -> None:
        """Seed the warm log from a persisted snapshot (before first spawn)."""
        with self._lock:
            for e in entries:
                if e.get("op") == "bool":
                    m = ("bool", np.asarray(e["q"], dtype=np.int32))
                elif e.get("op") == "topk":
                    m = (
                        "topk",
                        [
                            (tuple(t), tuple(r), int(k), int(f))
                            for t, r, k, f in e["items"]
                        ],
                    )
                else:
                    continue
                key = self._warm_key(m)
                if key is not None:
                    self._warm_log[key] = m

    def _ingest(self, wire: dict) -> None:
        """Land a reply's shipped telemetry on the host obs handles."""
        obs = self.obs
        if obs is None:
            return
        spans = wire.get("spans")
        if spans and obs.trace is not None and self.clock_offset_ns is not None:
            ingest_worker_spans(
                obs.trace,
                spans,
                offset_ns=self.clock_offset_ns,
                pid=self.pid,
                label=self.label,
            )
        probes = wire.get("probes")
        if probes and obs.probe_log is not None:
            obs.probe_log.ingest(probes)

    def close(self) -> None:
        with self._lock:
            if self.alive:
                try:
                    self._conn.send(("stop",))
                except (BrokenPipeError, OSError):
                    pass
                self._proc.join(timeout=2.0)
            self._fail_locked()


class ReplicaGroup:
    """Every replica able to serve one shard + the retry/dispatch policy."""

    def __init__(
        self,
        shard_id: int,
        replicas: list,
        *,
        lo: int = 0,
        n_docs: int = 0,
        retries: int = 1,
        metrics=None,
        obs=None,
    ):
        if not replicas:
            raise ValueError(f"shard {shard_id}: a replica group needs >= 1 replica")
        self.shard_id = shard_id
        self.replicas = replicas
        self.lo = lo  # global doc-id offset (the session's bitmap merge)
        self.n_docs = n_docs
        self.retries = retries
        self.obs = obs  # tracer re-activation on fan-pool threads
        self._retried = metrics.counter("sched.worker_retries") if metrics else None
        self._failed = metrics.counter("sched.worker_failures") if metrics else None

    def call(self, msg):
        """Dispatch to the least-loaded replica; retry once (per config) on
        failure, preferring a sibling replica; then raise WorkerFailure.

        Re-activates the session's tracer for the dispatch: multi-shard
        fan-out runs these calls on pool threads with no ambient tracer, and
        inline replicas record their spans through it (process replicas ship
        theirs back instead).
        """
        tracer = self.obs.trace if self.obs is not None else None
        last: Exception | None = None
        failed = None
        for attempt in range(self.retries + 1):
            replica = min(
                self.replicas, key=lambda r: (r is failed, r.inflight)
            )
            replica.inflight += 1
            try:
                with trace.activate(tracer):
                    return replica.call(msg)
            except ReplicaError as e:
                last = e
                failed = replica
                if self._retried is not None and attempt < self.retries:
                    self._retried.inc()
            finally:
                replica.inflight -= 1
        if self._failed is not None:
            self._failed.inc()
        raise WorkerFailure(
            shard_id=self.shard_id, attempts=self.retries + 1, detail=str(last)
        )

    def close(self) -> None:
        for r in self.replicas:
            r.close()
