"""run.py's harness finds configurations, traffic, systems, drivers and
metrics by the names in BENCHMARK.json, and picks up a cell added as files."""
from __future__ import annotations

import json
import time

import pytest

from port_bench.harness import Bench, run_cell

SEED = 2 ** 31 + 7


def test_every_name_resolves():
    bench = Bench()
    for w in bench.spec["workloads"]:
        cfg = bench.config(w["config"])
        traffic = bench.traffic(w["traffic"])
        assert (bench.pkg / "systems" / f"{cfg['system']}.py").is_file()
        assert (bench.pkg / "drivers" / f"{traffic['driver']}.py").is_file()
        for trace in (False, True):
            for m in bench.metrics(w["name"], trace):
                assert callable(bench.reader(m["name"]))
    names = {m["name"] for m in bench.spec["end_to_end"] + bench.spec["per_layer"]}
    files = {p.stem for p in (bench.pkg / "metrics").glob("*.py")} - {"__init__"}
    assert names == files


def test_metric_selection_by_cell_and_moves():
    bench = Bench()
    e2e = {m["name"] for m in bench.metrics("clueweb09b-exhaustive", False)}
    assert e2e == {"step_qps", "p95_ms", "setup_s"}
    layer = {m["name"] for m in bench.metrics("robust04-boolean-block", True)}
    assert "verify_ms_per_query" in layer and "membership_roofline" not in layer
    # a per-layer metric names its cells: one that names none is refused, not spread
    bench.spec["per_layer"].append({"name": "x", "moves": "setup_s", "unit": "s"})
    with pytest.raises(KeyError):
        bench.metrics("clueweb09b-exhaustive", True)


def test_a_cell_added_as_files_is_picked_up(tiny_root):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny_root / "port_bench/configs/clueweb09b-shard.json").read_text())
    cfg["name"] = "wide-shard"
    cfg["shard"]["docs"] = 4096
    (tiny_root / "port_bench/configs/wide-shard.json").write_text(json.dumps(cfg))
    traffic = json.loads((tiny_root / "port_bench/traffic/exhaustive-batch256.json").read_text())
    traffic["batch"] = 8
    (tiny_root / "port_bench/traffic/batch8.json").write_text(json.dumps(traffic))
    (tiny_root / "port_bench/metrics/batches_per_s.py").write_text(
        "def read(rec):\n    return len(rec['completed']) / rec['window_s']\n")
    spec["configs"].append({"name": "wide-shard", "source": "test",
                            "file": "port_bench/configs/wide-shard.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "wide.batch8", "config": "wide-shard",
                              "traffic": "batch8", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "batches_per_s", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "test", "moves": "step_qps",
                              "workloads": ["wide.batch8"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(tiny_root)
    for trace, want in ((False, {"step_qps", "p95_ms", "setup_s"}),
                        (True, {"membership_roofline", "step_mfu", "idle_share.step",
                                "batches_per_s"})):
        r = run_cell(bench, "wide.batch8", SEED, 0.3, trace, "cpu", time.perf_counter())
        assert r["correct"], r["checks"]
        # the CPU has no device trace: the readers of one find nothing to read
        got = set(r["metrics"])
        assert got <= want and ("batches_per_s" in got or not trace)
        assert list(r)[-1] == "checks"
