"""Rolling per-tenant SLO accounting for the serving scheduler.

"Benchmarking Learned Indexes" argues for full latency distributions over
single-point summaries; under overload the number an operator actually
watches is neither — it is the *deadline hit rate* per tenant over a recent
window, and how fast the error budget is burning.  ``SLOMonitor`` keeps a
bounded sliding window of per-request outcomes (served/shed, latency,
deadline met) per tenant and reports:

  deadline_hit_rate   fraction of windowed requests that were served within
                      their deadline (no deadline => served counts as met;
                      a shed request never does)
  p50_ms / p99_ms     latency percentiles over the *served* requests in the
                      window (exact — the window is a bounded sample, not a
                      fixed-bucket histogram)
  burn_rate           (1 - hit_rate) / (1 - target): 1.0 means the error
                      budget is being spent exactly at the sustainable
                      rate, >1 means the SLO will be violated if the window
                      is representative — the standard multiwindow-burn
                      alerting input

The monitor is a leaf: ``record`` takes one lock, appends one tuple, and
prunes lazily, so the session can call it from future callbacks (including
ones that fire under the admission queue's lock) without ordering concerns.
``Session.slo_report()`` pairs this per-tenant view with the registry's
``sched.*`` histograms for the whole-process distributions.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable


class SLOMonitor:
    """Sliding-window per-tenant deadline-hit-rate / latency / burn-rate."""

    def __init__(
        self,
        *,
        window_s: float = 60.0,
        target: float = 0.99,
        max_samples_per_tenant: int = 8192,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not 0.0 < target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1), got {target}")
        self.window_s = float(window_s)
        self.target = float(target)
        self._clock = clock
        self._lock = threading.Lock()
        # tenant -> deque of (t, latency_us, served, deadline_met); bounded
        # so a hot tenant can't grow memory, pruned by age on read/write
        self._windows: dict[str, deque] = {}
        self._maxlen = int(max_samples_per_tenant)

    # ------------------------------------------------------------- record
    def record(
        self, tenant: str, *, latency_us: float, served: bool, deadline_met: bool
    ) -> None:
        """One request outcome (served or shed) for ``tenant``."""
        now = self._clock()
        with self._lock:
            win = self._windows.get(tenant)
            if win is None:
                win = self._windows[tenant] = deque(maxlen=self._maxlen)
            self._prune_locked(win, now)
            win.append((now, float(latency_us), bool(served), bool(deadline_met)))

    def _prune_locked(self, win: deque, now: float) -> None:
        horizon = now - self.window_s
        while win and win[0][0] < horizon:
            win.popleft()

    # ------------------------------------------------------------- report
    @staticmethod
    def _percentile(sorted_vals: list[float], q: float) -> float:
        """Exact linear-interpolation percentile over a sorted sample."""
        if not sorted_vals:
            return 0.0
        pos = q / 100.0 * (len(sorted_vals) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(sorted_vals) - 1)
        return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo)

    def report(self) -> dict[str, dict]:
        """Per-tenant window summary: counts, hit rate, p50/p99, burn rate."""
        now = self._clock()
        out: dict[str, dict] = {}
        with self._lock:
            for tenant, win in self._windows.items():
                self._prune_locked(win, now)
                if not win:
                    continue
                n = len(win)
                served = [s for s in win if s[2]]
                hits = sum(1 for s in win if s[3])
                lat = sorted(s[1] for s in served)
                hit_rate = hits / n
                out[tenant] = {
                    "requests": n,
                    "served": len(served),
                    "shed": n - len(served),
                    "deadline_hit_rate": hit_rate,
                    "p50_ms": self._percentile(lat, 50) / 1e3,
                    "p99_ms": self._percentile(lat, 99) / 1e3,
                    "burn_rate": (1.0 - hit_rate) / (1.0 - self.target),
                }
        return out

    def reset(self) -> None:
        with self._lock:
            self._windows.clear()
