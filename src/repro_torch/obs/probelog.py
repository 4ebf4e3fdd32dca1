"""Structured probe-trace logging: one JSONL record per routed term.

The learned-serving-policies roadmap item wants to *learn* the
guided-vs-decode cost model instead of hand-tuning it; its training data is
exactly what the router sees plus what the probe actually cost.  Every time
``GuidedPostings`` routes a (query, term, shard) probe, it logs

  query / shard       ambient ids (set by the executor around each query)
  term, n_postings    the term and its local list length
  route               'guided' | 'decode' | 'fallback' | 'empty'
                      (decode = learned codec sent to full decode by the
                      cost model or planner hint; fallback = classical codec)
  n_cands / n_found   candidate-set size in and matches out
  eps_window          the model's expected ε-window width in ranks — the
                      feature the current hand-tuned router thresholds on
  bytes               stream bytes this probe actually touched
  wall_us             host wall clock of the probe

Records append as JSON lines (order = execution order); ``ProbeLog`` is
thread-safe, the ambient (query, shard) context is thread-local so the
shard fan-out pool attributes records correctly, and a path-less ProbeLog
collects records in memory (tests, notebooks).  A batched verify answers
many queries in one probe round, where no ambient context can name the
query: ``log`` then takes ``query``/``shard`` per record.  The JSONL is
the reference's, line for line, so either package reads the other's.  ``read()`` round-trips a
file back into ``ProbeRecord``s.

File sinks rotate: with ``max_bytes`` set, a file that grows past the cap
is renamed to ``<path>.1`` (replacing the previous rotation) and a fresh
file is opened — a long-running serve holds at most ~2x ``max_bytes`` of
probe history on disk instead of growing without bound.

Records also cross process boundaries: a worker replica logs into an
in-memory ProbeLog, ``drain()``s it into wire dicts after each request, and
the host ``ingest()``s them into its own sink — so the learned-routing
training data covers the process-replica path, not just inline serving.
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict, dataclass


@dataclass
class ProbeRecord:
    """One routed probe: the cost-model features and the measured outcome."""

    query: int
    shard: int
    term: int
    route: str
    n_cands: int
    n_found: int
    n_postings: int
    eps_window: float
    bytes: int
    wall_us: float

    def to_json(self) -> str:
        return json.dumps(asdict(self), separators=(",", ":"))

    @classmethod
    def from_json(cls, line: str) -> "ProbeRecord":
        return cls(**json.loads(line))


class _Context:
    __slots__ = ("_log", "_query", "_shard", "_prev")

    def __init__(self, log: "ProbeLog", query: int | None, shard: int | None):
        self._log = log
        self._query = query
        self._shard = shard

    def __enter__(self) -> "_Context":
        local = self._log._local
        self._prev = getattr(local, "ctx", (-1, -1))
        local.ctx = (
            self._prev[0] if self._query is None else self._query,
            self._prev[1] if self._shard is None else self._shard,
        )
        return self

    def __exit__(self, *exc) -> bool:
        self._log._local.ctx = self._prev
        return False


class ProbeLog:
    """JSONL probe-trace sink with ambient (query, shard) attribution."""

    def __init__(self, path: str | None = None, *, max_bytes: int | None = None):
        self.path = path
        self.max_bytes = max_bytes
        self._fh = open(path, "w") if path else None
        self._bytes = 0
        self.records: list[ProbeRecord] | None = [] if path is None else None
        self._lock = threading.Lock()
        self._local = threading.local()
        self.n_records = 0
        self.n_rotations = 0

    # ------------------------------------------------------------- context
    def context(
        self, *, query: int | None = -1, shard: int | None = -1
    ) -> _Context:
        """Attribute records logged inside the with-block to (query, shard).

        ``None`` inherits that half of the enclosing context — e.g. a worker
        sets ``context(shard=...)`` around a whole request without clobbering
        the per-query attribution the executor installs inside it.
        """
        return _Context(self, query, shard)

    def current(self) -> tuple[int, int]:
        """This thread's ambient (query, shard); (-1, -1) outside any context."""
        return getattr(self._local, "ctx", (-1, -1))

    # ------------------------------------------------------------- write
    def log(
        self,
        term: int,
        route: str,
        *,
        n_cands: int,
        n_found: int,
        n_postings: int,
        eps_window: float,
        bytes: int,
        wall_us: float,
        query: int | None = None,
        shard: int | None = None,
    ) -> None:
        """Append one record; ``query``/``shard`` override the ambient
        context (None keeps it)."""
        ctx_query, ctx_shard = self.current()
        query = ctx_query if query is None else query
        shard = ctx_shard if shard is None else shard
        rec = ProbeRecord(
            query=int(query),
            shard=int(shard),
            term=int(term),
            route=route,
            n_cands=int(n_cands),
            n_found=int(n_found),
            n_postings=int(n_postings),
            eps_window=float(eps_window),
            bytes=int(bytes),
            wall_us=float(wall_us),
        )
        with self._lock:
            self._append_locked(rec)

    def _append_locked(self, rec: ProbeRecord) -> None:
        self.n_records += 1
        if self._fh is not None:
            line = rec.to_json() + "\n"
            self._fh.write(line)
            self._bytes += len(line)
            if self.max_bytes is not None and self._bytes >= self.max_bytes:
                self._rotate_locked()
        else:
            self.records.append(rec)

    def _rotate_locked(self) -> None:
        """Size cap hit: current file becomes <path>.1 (previous rotation is
        replaced), a fresh file takes over — disk stays <= ~2x max_bytes."""
        self._fh.close()
        os.replace(self.path, self.path + ".1")
        self._fh = open(self.path, "w")
        self._bytes = 0
        self.n_rotations += 1

    # --------------------------------------------------------------- wire
    def drain(self) -> list[dict]:
        """Pop in-memory records as picklable wire dicts (worker -> host).

        Only meaningful for path-less logs (workers buffer in memory); a
        file-backed log already persists and drains nothing.
        """
        with self._lock:
            if self.records is None:
                return []
            records, self.records = self.records, []
        return [asdict(r) for r in records]

    def ingest(self, records: list[dict]) -> None:
        """Append wire dicts shipped from a worker replica into this sink."""
        recs = [ProbeRecord(**d) for d in records]
        with self._lock:
            for rec in recs:
                self._append_locked(rec)

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "ProbeLog":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ------------------------------------------------------------- read
    @staticmethod
    def read(path: str) -> list[ProbeRecord]:
        with open(path) as f:
            return [ProbeRecord.from_json(line) for line in f if line.strip()]
