"""What the benchmark reads of the card: a profiler window and nvidia-smi.

``profiled(path)`` records a torch.profiler trace of the window and writes it
as a Chrome trace; ``device_summary`` reduces it to the device's busy
seconds, the union of kernel, copy and set intervals inside the window (the
``record_function`` span named ``WINDOW``), the operations that took most
time and the longest idle gaps, each named by the innermost host operation
running when it began.  ``Smi`` samples ``nvidia-smi`` (utilization and
memory in use, every process on the card) every 100 ms in a process of its
own; it sees the kernels of other processes, which an in-process profiler
cannot.  nvidia-smi numbers every card of the host and ignores
``CUDA_VISIBLE_DEVICES``, so both read the line of the card whose UUID is
that of the one torch runs on (``card_uuid``).
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import threading
import time
from collections import defaultdict

from port_bench.stats import union_seconds

WINDOW = "port_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profiled(path: str):
    """Profile the block (host and device activity) and export it to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield
    prof.export_chrome_trace(path)


def device_summary(path: str, top: int = 10) -> dict:
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the profile holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    for e in spans:
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            s0, s1 = max(s, w0), min(s + d, w1)
            if s1 > s0:
                dev.append((s0, s1, e["name"]))
        elif e.get("cat") == "cpu_op":
            host.append((s, s + d, e["name"]))
    by_name: dict[str, float] = defaultdict(float)
    for s0, s1, n in dev:
        by_name[n] += (s1 - s0) / 1e6
    ivals = sorted((s0, s1) for s0, s1, _ in dev)
    gaps, end = [], w0
    for s0, s1 in ivals:
        if s0 > end:
            gaps.append((end, s0))
        end = max(end, s1)
    if w1 > end:
        gaps.append((end, w1))
    host.sort(key=lambda h: h[1] - h[0])

    def doing(t: float) -> str:
        for s, e, n in host:  # shortest first: the innermost op
            if s <= t < e:
                return n
        return "host idle"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": union_seconds((s0, s1) for s0, s1 in ivals) / 1e6,
        "by_name": dict(by_name),
        "device_ops": sorted(([n, t] for n, t in by_name.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": [[doing(s), (e - s) / 1e6] for s, e in gaps[:top]],
    }


def card_uuid(device: int = 0) -> str | None:
    """The UUID of torch's ``cuda:device`` as nvidia-smi prints it, or None
    without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    uuid = str(torch.cuda.get_device_properties(device).uuid).lower()
    return "GPU-" + uuid.removeprefix("gpu-")


def _rows(lines) -> list[list[str]]:
    return [[f.strip() for f in line.split(",")] for line in lines if line.strip()]


def _which(uuids: set[str], card: str) -> str | None:
    """Which of nvidia-smi's cards is torch's: the one whose UUID is ``card``;
    on a host with one card, that card whatever its UUID reads."""
    mine = [u for u in uuids if u.lower() == card.lower()]
    return mine[0] if mine else (next(iter(uuids)) if len(uuids) == 1 else None)


class Smi:
    """nvidia-smi samples of torch's card: (host perf_counter, util %, MiB used)."""

    def __init__(self, period_ms: int = 100):
        self.samples: list[tuple[float, float, float]] = []  # filled by stop()
        self._raw: list[tuple[float, list[str]]] = []
        self._proc = self._reader = None
        self.card = card_uuid()
        if self.card is None:
            return
        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=uuid,utilization.gpu,memory.used",
                 "--format=csv,noheader,nounits", "-lms", str(period_ms)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except FileNotFoundError:  # no card here: no samples
            return
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self._proc.stdout:
            self._raw += [(time.perf_counter(), row) for row in _rows([line])]

    def stop(self) -> None:
        if self._proc is None:
            return
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._reader.join(timeout=10)
        keep = _which({row[0] for _, row in self._raw}, self.card)
        for t, row in self._raw:
            try:
                if row[0] == keep:
                    self.samples.append((t, float(row[1]), float(row[2])))
            except (ValueError, IndexError):
                continue

    def between(self, t0: float, t1: float) -> list[tuple[float, float, float]]:
        return [s for s in self.samples if t0 <= s[0] <= t1]


def card_memory_used_bytes() -> int | None:
    """Device memory in use on torch's card by every process, or None
    without a card or nvidia-smi."""
    card = card_uuid()
    if card is None:
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=uuid,memory.used",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (FileNotFoundError, subprocess.SubprocessError):
        return None
    rows = _rows(out.splitlines())
    keep = _which({row[0] for row in rows}, card)
    mine = [row for row in rows if row[0] == keep]
    return int(float(mine[0][1])) * 2 ** 20 if mine else None
