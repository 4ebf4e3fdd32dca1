"""Unified request/response types for the serving front-end.

Every entry point — conjunctive Boolean, ranked top-k, the legacy
``query_*`` wrappers — is one shape on the wire now: a ``QueryRequest``
submitted to a ``Session`` resolves to exactly one of

  * ``QueryResult``  — the answer (doc ids, plus scores on the ranked path)
    with its queue/service timing attached, or
  * ``Rejected``     — a typed shed decision (queue saturation, tenant
    quota, missed deadline, worker failure, shutdown).  Nothing is ever
    dropped silently: an admitted request's future always resolves.

Both carry ``ok`` so callers can branch without isinstance checks.
``WorkerFailure`` is the internal typed error a replica group raises after
its retry budget is spent; the session converts it to ``Rejected`` results
for the affected requests.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Rejected.reason values (closed set; tests and benchmarks match on these)
REJECT_QUEUE_FULL = "queue_full"
REJECT_TENANT_QUOTA = "tenant_quota"
REJECT_DEADLINE = "deadline"
REJECT_WORKER_FAILED = "worker_failed"
REJECT_SHUTDOWN = "shutdown"

MODE_BOOLEAN = "boolean"
MODE_RANKED = "ranked"


@dataclass(eq=False)  # terms is an array; == would be elementwise-ambiguous
class QueryRequest:
    """One query for ``Session.submit`` (either serving mode).

    ``terms`` is a 1-D array/sequence of term ids, ``-1``-padded entries
    ignored.  ``mode`` picks conjunctive Boolean ("boolean") or BM25 top-k
    ("ranked"); ranked requests read ``k`` and the optional per-position
    ``required`` mask (True = this term is conjunctively required — an
    all-True mask is an AND-of-terms ranked query).  ``tenant`` and
    ``priority`` feed admission control: when the queue saturates, the
    lowest-priority queued request is shed first.  ``deadline_ms`` bounds
    the time from submit to dispatch — a request still queued past its
    deadline is shed with ``Rejected("deadline")`` and never reaches a
    worker (``SchedConfig.default_deadline_ms`` applies when unset).
    """

    terms: np.ndarray
    mode: str = MODE_BOOLEAN
    k: int = 10
    required: np.ndarray | None = None
    tenant: str = "default"
    priority: int = 0
    deadline_ms: float | None = None

    def __post_init__(self):
        if self.mode not in (MODE_BOOLEAN, MODE_RANKED):
            raise ValueError(f"mode must be 'boolean' or 'ranked', got {self.mode!r}")
        self.terms = np.atleast_1d(np.asarray(self.terms, dtype=np.int32))
        if self.terms.ndim != 1:
            raise ValueError(f"terms must be 1-D, got shape {self.terms.shape}")
        if self.required is not None:
            req = np.atleast_1d(np.asarray(self.required, dtype=bool))
            if req.shape != self.terms.shape:
                raise ValueError(
                    f"required mask shape {req.shape} != terms {self.terms.shape}"
                )
            self.required = req


@dataclass(eq=False)  # ids/scores are arrays; compare contents explicitly
class QueryResult:
    """The answer to an admitted request.

    ``ids`` are sorted doc ids for Boolean queries and (score desc, id asc)
    ranked doc ids with ``scores`` for ranked queries — bit-identical to the
    legacy ``query_batch`` / ``query_topk`` results for the same engine.
    """

    ids: np.ndarray
    scores: np.ndarray | None = None
    queue_us: float = 0.0  # submit -> dispatch
    service_us: float = 0.0  # dispatch -> resolved (whole coalesced batch)
    # service_us decomposed by the session: dispatch_us (row stacking +
    # planning), execute_us (shard fan-out wall), merge_us (bitmap/heap
    # fold) — None for short-circuited results that never saw a batch
    phases: dict | None = None

    @property
    def ok(self) -> bool:
        return True

    def autopsy(self) -> dict:
        """Where this request's latency went: queue/dispatch/execute/merge.

        Returns absolute microseconds plus each phase's fraction of the
        total (``*_frac``).  Phases cover the whole coalesced batch the
        request rode in — the scheduler amortizes, so a request's execute
        time is its batch's execute time.
        """
        phases = {
            "queue_us": self.queue_us,
            "dispatch_us": 0.0,
            "execute_us": 0.0,
            "merge_us": 0.0,
        }
        phases.update(self.phases or {})
        total = self.queue_us + self.service_us
        out = {"total_us": total, "service_us": self.service_us, **phases}
        for k, v in phases.items():
            out[k.replace("_us", "_frac")] = v / total if total > 0 else 0.0
        return out


@dataclass
class Rejected:
    """A typed shed decision — the request was NOT served.

    ``reason`` is one of the REJECT_* constants; ``detail`` is free-form
    context (e.g. the worker error after the retry budget is spent).
    """

    reason: str
    tenant: str = "default"
    detail: str = ""

    @property
    def ok(self) -> bool:
        return False


@dataclass
class WorkerFailure(RuntimeError):
    """A replica group exhausted its retry budget on one dispatched batch."""

    shard_id: int = -1
    attempts: int = 0
    detail: str = ""

    def __post_init__(self):
        super().__init__(
            f"shard {self.shard_id} failed after {self.attempts} attempt(s): "
            f"{self.detail}"
        )


# what Session.submit/submit_async futures resolve to
SubmitOutcome = QueryResult | Rejected
