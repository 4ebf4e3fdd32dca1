"""Admission control: a bounded query queue with tenants, priorities, deadlines.

The queue is the scheduler's only buffer, so admission is where overload
policy lives:

  * **bound** — at most ``SchedConfig.max_queue`` requests wait; when a new
    arrival finds the queue full, the *lowest-priority* queued request is
    shed (``Rejected("queue_full")``) to make room — ties shed the youngest,
    so FIFO order is disturbed as little as possible.  An arrival that is
    itself the lowest priority is rejected instead of churning the queue.
  * **tenant quota** — ``SchedConfig.tenant_quota`` caps queued requests per
    tenant (``Rejected("tenant_quota")``); one chatty tenant cannot convoy
    everyone else.
  * **deadline** — each entry carries an absolute monotonic deadline
    (request's ``deadline_ms`` or the config default).  ``take_batch``
    sheds expired entries (``Rejected("deadline")``) *before* they are
    handed to a worker: a request that already missed its budget never
    costs a dispatch.

``take_batch`` is also the coalescing point of continuous batching: it
blocks until work exists, optionally lingers ``batch_window_us`` for more
arrivals, then returns up to ``max_batch`` entries of the head's mode —
coalescing same-mode entries past other-mode ones (FIFO within each mode)
— so while workers are busy, arrivals pile up and the next dispatch is a
bigger batch.

Every decision is counted in the session's metrics registry
(``sched.enqueued``, ``sched.shed.*``) and the queue depth is a gauge;
shedding resolves the victim's future, so no request is ever silently
dropped.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np

from repro_torch.serve.sched.api import (
    REJECT_DEADLINE,
    REJECT_QUEUE_FULL,
    REJECT_SHUTDOWN,
    REJECT_TENANT_QUOTA,
    QueryRequest,
    Rejected,
)


@dataclass(eq=False)  # identity equality: rows are arrays, and each entry is unique
class Pending:
    """One admitted request waiting for dispatch."""

    req: QueryRequest
    future: Future
    row: np.ndarray  # padded int32 term row (the request's batch slice)
    t_submit: float  # monotonic seconds
    deadline: float | None  # absolute monotonic seconds, None = none
    seq: int = 0  # admission order (FIFO tie-break)

    def resolve(self, outcome) -> None:
        if not self.future.done():
            self.future.set_result(outcome)

    def reject(self, reason: str, detail: str = "") -> None:
        self.resolve(Rejected(reason=reason, tenant=self.req.tenant, detail=detail))


class AdmissionQueue:
    """Bounded, tenant-aware, deadline-shedding FIFO (see module doc)."""

    def __init__(self, sched_cfg, metrics, *, clock=time.monotonic):
        self.cfg = sched_cfg
        self.clock = clock
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._space = threading.Condition(self._lock)
        self._items: list[Pending] = []
        self._tenant_queued: dict[str, int] = {}
        self._seq = 0
        self._closed = False
        self._enqueued = metrics.counter("sched.enqueued")
        self._shed_full = metrics.counter("sched.shed.queue_full")
        self._shed_quota = metrics.counter("sched.shed.tenant_quota")
        self._shed_deadline = metrics.counter("sched.shed.deadline")
        self._depth = metrics.gauge("sched.queue_depth")

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    # ------------------------------------------------------------- admit
    def offer(self, pending: Pending, *, block: bool = False) -> bool:
        """Admit ``pending`` or resolve it as Rejected; True iff admitted.

        ``block=True`` (the legacy sync wrappers) waits for space instead of
        shedding — those callers have no deadline and expect backpressure.
        """
        tenant = pending.req.tenant
        with self._lock:
            if self._closed:
                pending.reject(REJECT_SHUTDOWN)
                return False
            quota = self.cfg.tenant_quota
            if quota is not None and self._tenant_queued.get(tenant, 0) >= quota:
                self._shed_quota.inc()
                pending.reject(
                    REJECT_TENANT_QUOTA,
                    detail=f"tenant {tenant!r} already has {quota} queued",
                )
                return False
            while len(self._items) >= self.cfg.max_queue:
                if block:
                    self._space.wait(timeout=0.05)
                    if self._closed:
                        pending.reject(REJECT_SHUTDOWN)
                        return False
                    continue
                if not self._shed_for(pending):
                    self._shed_full.inc()
                    pending.reject(
                        REJECT_QUEUE_FULL,
                        detail=f"queue at max_queue={self.cfg.max_queue}",
                    )
                    return False
            pending.seq = self._seq
            self._seq += 1
            self._items.append(pending)
            self._tenant_queued[tenant] = self._tenant_queued.get(tenant, 0) + 1
            self._enqueued.inc()
            self._depth.set(len(self._items))
            self._nonempty.notify()
        return True

    def _shed_for(self, incoming: Pending) -> bool:
        """Evict the lowest-priority queued victim to admit ``incoming``.

        Victim = min priority, youngest first among ties (preserves the
        FIFO head).  Only a strictly higher-priority arrival may displace —
        equal priority rejects the newcomer, not the queue.  Lock held.
        """
        if not self._items:
            return False
        victim = min(self._items, key=lambda p: (p.req.priority, -p.seq))
        if victim.req.priority >= incoming.req.priority:
            return False
        self._items.remove(victim)
        self._drop_tenant(victim.req.tenant)
        self._shed_full.inc()
        victim.reject(
            REJECT_QUEUE_FULL,
            detail=f"shed for priority-{incoming.req.priority} arrival",
        )
        return True

    def _drop_tenant(self, tenant: str) -> None:
        n = self._tenant_queued.get(tenant, 0) - 1
        if n <= 0:
            self._tenant_queued.pop(tenant, None)
        else:
            self._tenant_queued[tenant] = n

    # ------------------------------------------------------------- drain
    def take_batch(self, max_batch: int) -> list[Pending]:
        """Block until work exists; return a same-mode batch (<= max_batch).

        Expired entries are shed here — *before* dispatch — so a request
        past its deadline never reaches a worker.  Returns [] only when the
        queue is closed and empty.
        """
        with self._lock:
            while True:
                self._expire_locked()
                if self._items:
                    break
                if self._closed:
                    return []
                self._nonempty.wait(timeout=0.05)
            if self.cfg.batch_window_us > 0 and len(self._items) < max_batch:
                deadline = self.clock() + self.cfg.batch_window_us / 1e6
                while len(self._items) < max_batch:
                    left = deadline - self.clock()
                    if left <= 0 or self._closed:
                        break
                    self._nonempty.wait(timeout=left)
                self._expire_locked()
                if not self._items:
                    return []
            if self.cfg.coalesce_us > 0 and len(self._items) < max_batch:
                # bounded coalescing window, anchored to the *head* arrival's
                # submit time: light-load singleton batches linger for
                # stragglers, but a batch that already aged while runners
                # were busy dispatches immediately — no request ever waits
                # more than coalesce_us beyond its submit for batching
                deadline = self._items[0].t_submit + self.cfg.coalesce_us / 1e6
                while len(self._items) < max_batch:
                    left = deadline - self.clock()
                    if left <= 0 or self._closed:
                        break
                    self._nonempty.wait(timeout=left)
                self._expire_locked()
                if not self._items:
                    return []
            # the head's mode goes first, and later same-mode entries
            # coalesce past other-mode entries (FIFO preserved *within*
            # each mode; the skipped mode is left at the head for the next
            # round).  A strict prefix would break every batch at a mode
            # switch, and a mixed workload would pay the per-dispatch cost
            # once per mode *run* instead of once per max_batch.
            mode = self._items[0].req.mode
            batch: list[Pending] = []
            keep: list[Pending] = []
            for p in self._items:
                if len(batch) < max_batch and p.req.mode == mode:
                    self._drop_tenant(p.req.tenant)
                    batch.append(p)
                else:
                    keep.append(p)
            self._items = keep
            self._depth.set(len(self._items))
            self._space.notify_all()
        return batch

    def _expire_locked(self) -> None:
        now = self.clock()
        live = []
        for p in self._items:
            if p.deadline is not None and now > p.deadline:
                self._drop_tenant(p.req.tenant)
                self._shed_deadline.inc()
                p.reject(
                    REJECT_DEADLINE,
                    detail=f"queued {1e3 * (now - p.t_submit):.1f}ms past deadline",
                )
            else:
                live.append(p)
        if len(live) != len(self._items):
            self._items[:] = live
            self._depth.set(len(live))
            self._space.notify_all()

    def close(self) -> None:
        """Reject everything still queued and wake all waiters."""
        with self._lock:
            self._closed = True
            for p in self._items:
                self._drop_tenant(p.req.tenant)
                p.reject(REJECT_SHUTDOWN)
            self._items.clear()
            self._depth.set(0)
            self._nonempty.notify_all()
            self._space.notify_all()
