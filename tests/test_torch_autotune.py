"""The port's tile autotuner and the dense pass's tile API against the
reference, on the CPU.

Same seeds give the same workload and byte-identical synthetic tables;
``set_tile_params``/``tile_params`` behave as the reference's; under each
quanta pair of the search grid, the port's ``_dispatch_dense`` pads a
batch to the reference's (Qb, T) and returns its ids, scores and rounds;
the cache round trip keeps other devices' entries; a tiny search on the
CPU picks a pair from the grid.  Tolerance: exact everywhere.  The tile
params are process-wide, so every test restores both packages' defaults.
"""
import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as ref_autotune
from repro.kernels.fused_query import dense as ref_dense
from repro.kernels.fused_query import ops as ref_ops
from repro.rank.topk import RankedStats as RefRankedStats
from repro_torch.kernels import autotune
from repro_torch.kernels.fused_query import dense
from repro_torch.kernels.fused_query import ops as fused_ops
from repro_torch.rank import RankedStats


@pytest.fixture(autouse=True)
def _default_tiles():
    for mod in (dense, ref_dense):
        mod.set_tile_params(8, 4)
    yield
    for mod in (dense, ref_dense):
        mod.set_tile_params(8, 4)


@pytest.mark.parametrize("n,quantum", [(0, 1), (1, 8), (8, 8), (9, 8), (13, 4), (64, 4), (65, 16),
                                       (3, 5)])
def test_bucket_matches_reference(n, quantum):
    assert autotune._bucket(n, quantum) == ref_autotune._bucket(n, quantum)
    assert fused_ops._bucket(n, quantum) == ref_autotune._bucket(n, quantum)


@pytest.mark.parametrize("seed", [0, 8, 123])
def test_workload_matches_reference(seed):
    got = autotune._workload(300, (1, 3, 5, 16), 6, seed)
    want = ref_autotune._workload(300, (1, 3, 5, 16), 6, seed)
    assert [[list(map(int, q)) for q in b] for b in got] == \
        [[list(map(int, q)) for q in b] for b in want]


def test_synthetic_arena_matches_reference_byte_for_byte():
    got = autotune._synthetic_arena(1000, 64, 30, seed=5, device="cpu")
    want = ref_autotune._synthetic_arena(1000, 64, 30, seed=5)
    assert got.table.dtype == torch.uint8 and got.table.device.type == "cpu"
    assert np.array_equal(got.table.numpy(), np.asarray(want.table))
    assert np.array_equal(got.host_lens, want.host_lens)
    assert (got.n_docs, got.n_terms) == (want.n_docs, want.n_terms)


def test_tile_params_round_trip_matches_reference():
    for mod in (dense, ref_dense):
        assert mod.tile_params() == {"row_quantum": 8, "term_quantum": 4}
    for args in ((16, 2), (None, 8), (0, None), (-3, -1)):
        dense.set_tile_params(*args)
        ref_dense.set_tile_params(*args)
        assert dense.tile_params() == ref_dense.tile_params()
    assert dense.tile_params() == {"row_quantum": 1, "term_quantum": 1}


@pytest.mark.parametrize("row_q", autotune.ROW_QUANTA)
@pytest.mark.parametrize("term_q", autotune.TERM_QUANTA)
def test_dispatch_dense_pads_like_reference(row_q, term_q):
    """A batch of 5 items, the widest with 5 terms, two k buckets: the
    padded (Qb, T) of each pass and its outputs equal the reference's."""
    assert autotune.ROW_QUANTA == ref_autotune.ROW_QUANTA
    assert autotune.TERM_QUANTA == ref_autotune.TERM_QUANTA
    arena = autotune._synthetic_arena(600, 40, 60, seed=3, device="cpu")
    ref_arena = ref_autotune._synthetic_arena(600, 40, 60, seed=3)
    items = [(0, [1, 5, 9], 10, 0), (1, [2, 3, 4, 7, 11], 10, 4), (2, [6], 3, 0),
             (3, [12, 30], 10, 1000), (4, [0, 39], 3, 2)]
    dense.set_tile_params(row_q, term_q)
    ref_dense.set_tile_params(row_q, term_q)
    stats, ref_stats = RankedStats(), RefRankedStats()
    got = fused_ops._dispatch_dense(arena, items, stats)
    want = ref_ops._dispatch_dense(ref_arena, items, ref_stats)
    assert len(got) == len(want) == 2
    for (_, grp, kb, Qb, T, out), (_, rgrp, rkb, rQb, rT, rout) in zip(got, want):
        assert (kb, Qb, T) == (rkb, rQb, rT)
        assert Qb % row_q == 0 and T % term_q == 0 and [g[0] for g in grp] == [g[0] for g in rgrp]
        ids, scores, rounds = out
        assert tuple(ids.shape) == (Qb, kb)
        assert np.array_equal(ids.numpy(), np.asarray(rout[0]))
        assert np.array_equal(scores.numpy(), np.asarray(rout[1])) and int(rounds) == int(rout[2])
    for f in ("fused_queries", "fused_lanes", "fused_stream_bytes"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert dense.observed_shapes() and {(600, Qb, T, kb) for _, _, kb, Qb, T, _ in got} <= set(
        dense.observed_shapes())


def test_cache_round_trip_leaves_other_devices(tmp_path):
    path = str(tmp_path / "sub" / "cache.json")
    other = {"cuda:Some Card": {"dense": {"row_quantum": 4, "term_quantum": 2}}}
    (tmp_path / "sub").mkdir()
    with open(path, "w") as f:
        json.dump(other, f)
    report = {"device": "cpu", "dense": {"row_quantum": 16, "term_quantum": 8},
              "timings_us": {"16x8": 1.0}}
    autotune.save_cache(report, path)
    with open(path) as f:
        cache = json.load(f)
    assert cache["cuda:Some Card"] == other["cuda:Some Card"]
    assert cache["cpu"] == {"dense": {"row_quantum": 16, "term_quantum": 8},
                            "timings_us": {"16x8": 1.0}}
    entry = autotune.apply_cache(path, device="cpu")
    assert entry == cache["cpu"] and dense.tile_params() == {"row_quantum": 16, "term_quantum": 8}
    dense.set_tile_params(8, 4)
    assert autotune.apply_cache(str(tmp_path / "missing.json"), device="cpu") is None
    (tmp_path / "bad.json").write_text("{not json")
    assert autotune.apply_cache(str(tmp_path / "bad.json"), device="cpu") is None
    assert dense.tile_params() == {"row_quantum": 8, "term_quantum": 4}
    assert autotune.device_key("cpu") == "cpu"
    assert autotune.DEFAULT_CACHE != ref_autotune.DEFAULT_CACHE  # neither reads the other's


def test_autotune_dense_on_cpu_picks_from_the_grid(tmp_path):
    path = str(tmp_path / "cache.json")
    report = autotune.autotune_dense(n_docs=256, n_terms=32, avg_len=10, batch_sizes=(1, 5),
                                     reps=1, device="cpu", cache_path=path)
    best = (report["dense"]["row_quantum"], report["dense"]["term_quantum"])
    assert best in {(r, t) for r in autotune.ROW_QUANTA for t in autotune.TERM_QUANTA}
    assert set(report["timings_us"]) == {f"{r}x{t}" for r in autotune.ROW_QUANTA
                                         for t in autotune.TERM_QUANTA}
    assert report["best_us"] == min(report["timings_us"].values())
    assert dense.tile_params() == {"row_quantum": best[0], "term_quantum": best[1]}
    with open(path) as f:
        assert json.load(f)["cpu"]["dense"] == report["dense"]
