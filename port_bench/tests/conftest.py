"""Shared fixtures: a copy of the benchmark at a size a CPU test run holds."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY = {
    "robust04": {"collection": {"n_docs": 4000, "n_terms": 2000, "avg_doc_len": 60},
                 "model": {"train_steps": 20, "train_batch": 256, "embed_dim": 16,
                           "truncation_k": 100},
                 "serve": {"shards": 2, "replicas": 0}},
    "clueweb09b-shard": {"shard": {"docs": 8192, "terms": 500, "embed": 32}},
}
TINY_TRAFFIC = {
    "boolean-closed32": {"clients": 4, "pool": 192, "strata": 16, "warm_queries": 16},
    "exhaustive-batch256": {"batch": 16, "pool_batches": 4, "check_batches": 3},
}


def _merge(d: dict, patch: dict) -> None:
    for k, v in patch.items():
        if isinstance(v, dict):
            _merge(d[k], v)
        else:
            d[k] = v


def shrink(root: Path) -> None:
    """Cut the copy's configurations and traffic to test size."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        _merge(cfg, TINY.get(c["name"], {}))
        path.write_text(json.dumps(cfg))
    for name, patch in TINY_TRAFFIC.items():
        path = root / "port_bench" / "traffic" / f"{name}.json"
        t = json.loads(path.read_text())
        t.update(patch)
        path.write_text(json.dumps(t))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A checkout holding BENCHMARK.json and port_bench/, cut to test size."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shrink(tmp_path)
    return tmp_path
