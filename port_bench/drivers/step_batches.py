"""Batches handed to a step back to back, at most ``in_flight`` outstanding.

Traffic keys: ``batch`` (queries a step), ``pool_batches`` (batches drawn
from the seed and uploaded in set-up, sent in turn), ``warm_steps``,
``in_flight`` and ``check_batches`` (batches whose words are kept, drawn
from the seed by reservoir sampling over the window, for the reference).
Batch i + 1 is handed to the step before batch i's completion event is
awaited.  A batch's latency runs from its hand-over (host clock) to its
completion event, placed on the host clock through an event recorded when
the window opened.  With ``trace`` the window runs under torch.profiler.

Kept words go to pinned host buffers (allocated in set-up) on a stream of
their own, once their batch is complete, so the check's copies neither
hold device memory nor wait in the step's stream: ``memory_peak_bytes`` is
the step's, its tables' and its queries' peak.
"""
from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from port_bench import devtrace


def drive(system, traffic: dict, seed: int, seconds: float, trace: bool, setup) -> dict:
    dev = system.device
    cuda = dev.type == "cuda"
    rng = np.random.default_rng([seed, 1])
    with setup.stage("traffic"):
        pool, work = system.batch_pool(rng, traffic["pool_batches"], traffic["batch"],
                                       traffic["mix"])
    with setup.stage("warm_steps"):
        for i in range(traffic["warm_steps"]):
            system.step(pool[i % len(pool)])
        if cuda:
            torch.cuda.synchronize()
    keep_rng = np.random.default_rng([seed, 3])
    n_keep = traffic["check_batches"]
    with setup.stage("check_buffers"):
        store = _Kept(system.step(pool[0]), n_keep)
    kept: list = []  # (batch index, slot of store)
    done: list = []  # (batch index, t_handed, t_done)
    path = os.path.join(tempfile.gettempdir(), f"port_bench_trace_{os.getpid()}.json")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ctx = devtrace.profiled(path) if trace else contextlib.nullcontext()
    with ctx:
        t_start = setup.window_started()
        t_end = t_start + seconds
        ev0 = _event(cuda)
        out = collections.deque()
        i = 0

        def finish():
            b, t_h, ev, words = out.popleft()
            if cuda:
                ev.synchronize()
                t_d = t_start + ev0.elapsed_time(ev) / 1e3
            else:
                t_d = time.perf_counter()
            done.append((b, t_h, t_d))
            n = len(done)  # reservoir: each finished batch kept with probability k/n
            if len(kept) < n_keep:
                kept.append((b, store.put(len(kept), words)))
            elif keep_rng.random() < n_keep / n:
                slot = int(keep_rng.integers(n_keep))
                kept[slot] = (b, store.put(slot, words))

        while time.perf_counter() < t_end:
            t_h = time.perf_counter()
            words = system.step(pool[i % len(pool)])
            out.append((i, t_h, _event(cuda), words))
            while len(out) >= traffic["in_flight"]:
                finish()
            i += 1
        while out:
            finish()
    rec = {
        "window_s": t_end - t_start,
        "attempted": len(done) * traffic["batch"],
        "failed": 0,
        "batch": traffic["batch"],
        "latency_s": [t_d - t_h for _, t_h, t_d in done if t_d <= t_end],
        "completed": [work[b % len(pool)] for b, _, t_d in done if t_d <= t_end],
        "stepped": [work[b % len(pool)] for b, _, _ in done],
        "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
    }
    if trace:
        summary = devtrace.device_summary(path)
        os.remove(path)
        rec.update(busy_s=summary["busy_s"], traced_window_s=summary["window_s"],
                   kernel_s=summary["by_name"],
                   breakdown={"device_ops": summary["device_ops"],
                              "idle_gaps": summary["idle_gaps"]})
    rec["to_check"] = [(pool[b % len(pool)], store.get(slot)) for b, slot in kept]
    return rec


class _Kept:
    """``n`` host copies of result words like ``like``, written off the step's stream."""

    def __init__(self, like: torch.Tensor, n: int):
        self.cuda = like.is_cuda
        self.slots = [None] * n
        if self.cuda:
            torch.cuda.synchronize()
            self.host = torch.empty((n, *like.shape), dtype=like.dtype, pin_memory=True)
            self.stream = torch.cuda.Stream()
            self.copied = [None] * n

    def put(self, slot: int, words: torch.Tensor) -> int:
        """Copy a complete batch's ``words`` into ``slot``; -> ``slot``."""
        if not self.cuda:
            self.slots[slot] = words
            return slot
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()  # the slot's last copy has landed
        with torch.cuda.stream(self.stream):
            self.host[slot].copy_(words, non_blocking=True)
            words.record_stream(self.stream)
            self.copied[slot] = self.stream.record_event()
        self.slots[slot] = self.host[slot]
        return slot

    def get(self, slot: int) -> torch.Tensor:
        if self.cuda:
            self.copied[slot].synchronize()
        return self.slots[slot]


def _event(cuda: bool):
    if not cuda:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev
