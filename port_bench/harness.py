"""One run of one cell, driven by data.

``BENCHMARK.json`` at the checkout's root names the cell's configuration,
traffic and metrics; everything else is found by those names under
``port_bench/``:

  configs/<file named by the configuration>   sizes, guarantees, ``system``
  traffic/<traffic>.json                      parameters, ``driver``
  systems/<system>.py                         builds the port's path (``build``)
  drivers/<driver>.py                         draws and drives the traffic (``drive``)
  metrics/<metric>.py                         reduces the window's record (``read``)

so a later cell, configuration or metric is a new file and a new entry.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


class Setup:
    """Set-up's clock: process start to the window's start, stage by stage."""

    def __init__(self, t_process: float, device):
        self.t_process = t_process
        self.cuda = torch.device(device).type == "cuda"
        self.stages: dict[str, float] = {}
        self.t_window: float | None = None

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.cuda:
                torch.cuda.synchronize()
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0
            print(f"[port_bench] {name}: {self.stages[name]:.3f} s", file=sys.stderr, flush=True)

    def window_started(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        self.t_window = time.perf_counter()
        return self.t_window

    @property
    def setup_s(self) -> float:
        return self.t_window - self.t_process


def load_module(path: Path, tag: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {tag} file {path}")
    name = "port_bench_" + tag + "_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """BENCHMARK.json and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.pkg = self.root / "port_bench"

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.pkg / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
        e2e = [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        return [m for m in self.spec["per_layer"] if cell in m["workloads"]]

    def reader(self, metric: str):
        return load_module(self.pkg / "metrics" / f"{metric}.py", "metric").read


def run_cell(bench: Bench, cell: str, seed: int, seconds: float, trace: bool, device,
             t_process: float, control: bool = False) -> dict:
    """-> the result line's object (``checks`` last)."""
    wl = bench.workload(cell)
    cfg = bench.config(wl["config"])
    traffic = bench.traffic(wl["traffic"])
    system_mod = load_module(bench.pkg / "systems" / f"{cfg['system']}.py", "system")
    driver = load_module(bench.pkg / "drivers" / f"{traffic['driver']}.py", "driver")
    readers = [(m, bench.reader(m["name"])) for m in bench.metrics(cell, trace)]
    setup = Setup(t_process, device)
    system = system_mod.build(cfg, seed, device, setup, control=control)
    try:
        rec = driver.drive(system, traffic, seed, seconds, trace, setup)
        t0 = time.perf_counter()
    finally:
        system.close()
    rec["setup_s"] = setup.setup_s
    rec["setup"] = dict(setup.stages)
    rec["footprint"] = system.footprint
    t1 = time.perf_counter()
    checks = system.check(rec.pop("to_check"))
    print(f"[port_bench] after the window: close {t1 - t0:.3f} s, reference "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr, flush=True)
    checks["unanswered"] = {"value": rec["failed"], "limit": 0}
    metrics = {}
    for m, read in readers:
        value = read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": wl["chips"],
        "memory_peak_bytes": int(rec["memory_peak_bytes"]),
    }
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": int(rec["attempted"]),
        "failed": int(rec["failed"]),
        "metrics": metrics,
        "device": device_info,
    }
    if trace:
        device_info["busy_s"] = rec.get("busy_s")
        device_info["window_s"] = rec.get("traced_window_s", rec["window_s"])
        if "breakdown" in rec:
            result["breakdown"] = rec["breakdown"]
    result["checks"] = checks
    return result
