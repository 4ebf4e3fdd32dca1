"""The port's observability (repro_torch.obs and the engine's hooks) against
the reference's ``tests/test_obs.py``, case for case, plus parity cases.

The unit half pins the primitives — span nesting/ordering and Chrome-trace
schema, histogram percentile math against numpy quantiles, probe-log JSONL
round-trips, registry snapshot/reset semantics.  The integration half
serves real batches through a traced port engine on the CPU and checks the
contract: every query phase shows up as a span, one probe record per routed
(query, term, shard), ``serving_stats()`` is the deprecated alias of
``metrics.snapshot()``, and tracing off records nothing.  The parity cases
import both packages: the same observations give equal histogram
percentiles and registry snapshots (exact: the buckets are the same), a
probe log written by either package reads back in the other, and the same
batch through both engines gives the same probe-record multiset (``wall_us``
and order aside), the same ``guided``/``summary``/``queries`` sections and
span names covering the reference's.
"""
import collections
import json
import os
import tempfile
import threading
import warnings

import numpy as np
import pytest

from repro_torch.common.config import CorpusConfig, LearnedIndexConfig
from repro_torch.core.learned_bloom import fit_thresholds
from repro_torch.core.membership import params_from_jax
from repro_torch.data.corpus import synthesize_corpus
from repro_torch.data.queries import sample_queries, zipf_conjunctions, zipf_disjunctions
from repro_torch.index.build import build_inverted_index
from repro_torch.obs import (
    NULL_SPAN, Counter, Gauge, Histogram, ProbeLog, ProbeRecord, Registry,
    Tracer, trace,
)
from repro_torch.serve import BooleanEngine, ServeConfig


# ---------------------------------------------------------------- tracer
def test_span_nesting_order_and_depth():
    tr = Tracer()
    with tr.activate():
        with trace.span("outer", level=0):
            with trace.span("inner") as sp:
                sp.set(bytes=42)
    # spans record at __exit__, innermost first
    assert [s.name for s in tr.spans] == ["inner", "outer"]
    inner, outer = tr.spans
    assert (inner.depth, outer.depth) == (1, 0)
    assert inner.attrs == {"bytes": 42} and outer.attrs == {"level": 0}
    # wall-clock containment: the outer span brackets the inner one
    assert outer.ts_us <= inner.ts_us
    assert outer.ts_us + outer.dur_us >= inner.ts_us + inner.dur_us


def test_chrome_trace_schema():
    tr = Tracer()
    with tr.activate():
        with trace.span("a", k=1):
            with trace.span("b"):
                pass
    doc = tr.chrome_trace()
    assert doc["displayTimeUnit"] == "ms"
    assert doc["otherData"]["n_spans"] == 2
    spans = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
    meta = [ev for ev in doc["traceEvents"] if ev["ph"] == "M"]
    assert len(spans) == 2
    for ev in spans:
        assert set(ev) == {"name", "cat", "ph", "ts", "dur", "pid", "tid", "args"}
        assert ev["cat"] == "serve"
        assert ev["dur"] >= 0.0
    # the host lane is prenamed after the tracer
    assert {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": tr.name}} in meta
    json.dumps(doc)  # must be valid JSON end to end
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.trace.json")
        tr.save(path)
        with open(path) as f:
            assert json.load(f) == doc


def test_trace_off_is_the_null_singleton():
    assert trace.current() is None
    h = trace.span("anything", bytes=1)
    assert h is NULL_SPAN  # shared instance: no allocation when tracing is off
    assert h.set(more=2) is NULL_SPAN
    with h:
        pass


def test_activate_none_preserves_outer_tracer():
    tr = Tracer()
    with tr.activate():
        # an engine whose config carries no tracer must not mask the caller's
        with trace.activate(None):
            assert trace.current() is tr
            with trace.span("seen"):
                pass
    assert [s.name for s in tr.spans] == ["seen"]
    assert trace.current() is None


def test_spans_carry_worker_thread_ids():
    tr = Tracer()
    barrier = threading.Barrier(2)  # overlap lifetimes so idents differ

    def worker():
        barrier.wait()
        with trace.activate(tr), trace.span("w"):
            pass
        barrier.wait()

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tids = {s.tid for s in tr.spans}
    assert len(tr.spans) == 2 and len(tids) == 2


def test_tracer_reset_clears_spans_and_epoch():
    tr = Tracer()
    with tr.activate(), trace.span("x"):
        pass
    assert tr.spans
    tr.reset()
    assert tr.spans == []
    with tr.activate(), trace.span("y"):
        pass
    assert tr.spans[0].ts_us >= 0.0  # new epoch: timestamps restart near zero


# ---------------------------------------------------------------- metrics
def test_counter_gauge_basics():
    c, g = Counter(), Gauge()
    c.inc()
    c.inc(4)
    g.set(2.5)
    assert c.snapshot() == 5 and g.snapshot() == 2.5
    c.reset()
    g.reset()
    assert c.snapshot() == 0 and g.snapshot() == 0.0


def test_histogram_percentiles_linear_buckets():
    # controlled edges: interpolation error is bounded by one bucket width
    values = np.arange(1.0, 1001.0)
    h = Histogram(buckets=list(np.arange(0.0, 1001.0, 10.0)))
    for v in np.random.default_rng(0).permutation(values):
        h.observe(v)
    for q in (1, 10, 25, 50, 75, 90, 99):
        assert abs(h.percentile(q) - np.percentile(values, q)) <= 10.5, q
    s = h.snapshot()
    assert s["count"] == 1000 and s["min"] == 1.0 and s["max"] == 1000.0
    assert abs(s["mean"] - values.mean()) < 1e-9


def test_histogram_percentiles_default_log_buckets():
    # default buckets are quarter-decade: estimates stay within ~one bucket
    # (factor 10**0.25) of the numpy quantile on a heavy-tailed sample
    rng = np.random.default_rng(7)
    values = np.clip(rng.lognormal(np.log(500.0), 1.0, size=5000), 1.0, 1e6)
    h = Histogram()
    for v in values:
        h.observe(v)
    for q in (50, 90, 99):
        est, ref = h.percentile(q), float(np.percentile(values, q))
        assert ref / 10**0.3 <= est <= ref * 10**0.3, (q, est, ref)
    # clamped to observed extremes
    assert h.percentile(0) == values.min()
    assert h.percentile(100) == values.max()


def test_histogram_empty_and_reset():
    h = Histogram()
    assert h.snapshot() is None and h.percentile(50) == 0.0
    h.observe(3.0)
    assert h.snapshot()["count"] == 1
    with pytest.raises(ValueError):
        h.percentile(101)
    h.reset()
    assert h.snapshot() is None


def test_registry_dotted_names_collectors_and_reset():
    reg = Registry()
    reg.counter("latency.plan_us")  # histogram name collision must be loud
    with pytest.raises(TypeError):
        reg.histogram("latency.plan_us")
    reg.counter("queries.ranked").inc(3)
    reg.histogram("latency.query_us").observe(100.0)
    section = {"hits": 1}
    resets = []
    reg.register("cache", lambda: section, reset=lambda: resets.append(True))
    reg.register("ranked", lambda: None)  # None -> key omitted
    snap = reg.snapshot()
    assert snap["queries"]["ranked"] == 3
    assert snap["latency"]["query_us"]["count"] == 1
    assert snap["cache"] == {"hits": 1} and "ranked" not in snap
    reg.reset()
    assert resets == [True]
    snap = reg.snapshot()
    assert snap["queries"]["ranked"] == 0 and "query_us" not in snap.get("latency", {})


# ---------------------------------------------------------------- probe log
def test_probelog_jsonl_round_trip():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "probes.jsonl")
        log = ProbeLog(path)
        with log.context(query=3, shard=1):
            log.log(17, "guided", n_cands=8, n_found=2, n_postings=100,
                    eps_window=6.5, bytes=96, wall_us=12.25)
        log.log(9, "fallback", n_cands=4, n_found=4, n_postings=4,
                eps_window=0.0, bytes=16, wall_us=3.0)  # outside any context
        log.close()
        back = ProbeLog.read(path)
    assert back == [
        ProbeRecord(query=3, shard=1, term=17, route="guided", n_cands=8,
                    n_found=2, n_postings=100, eps_window=6.5, bytes=96,
                    wall_us=12.25),
        ProbeRecord(query=-1, shard=-1, term=9, route="fallback", n_cands=4,
                    n_found=4, n_postings=4, eps_window=0.0, bytes=16,
                    wall_us=3.0),
    ]


def test_probelog_in_memory_and_context_restore():
    log = ProbeLog()
    with log.context(query=1, shard=0):
        with log.context(query=2, shard=1):
            log.log(5, "guided", n_cands=1, n_found=1, n_postings=9,
                    eps_window=2.0, bytes=8, wall_us=1.0)
        log.log(6, "decode", n_cands=1, n_found=0, n_postings=9,
                eps_window=2.0, bytes=8, wall_us=1.0)
    assert [(r.query, r.shard) for r in log.records] == [(2, 1), (1, 0)]
    assert log.n_records == 2


# ---------------------------------------------------------------- engine
def _collection():
    """The reference test's collection (600 docs, 2000 terms, seed 13) with
    membership parameters made with numpy from a seed."""
    corpus = synthesize_corpus(CorpusConfig(n_docs=600, n_terms=2000, avg_doc_len=40, seed=13))
    inv = build_inverted_index(corpus)
    rng = np.random.default_rng(0)
    params = {
        "term_embed": {"table": (rng.standard_normal((2000, 16)) * 0.3).astype(np.float32)},
        "doc_embed": {"table": (rng.standard_normal((600, 16)) * 0.3).astype(np.float32)},
        "bias": np.float32(0.0),
    }
    return corpus, inv, params


@pytest.fixture(scope="module")
def served():
    """One engine serving boolean + ranked batches with full observability."""
    corpus, inv, params = _collection()
    li = LearnedIndexConfig(embed_dim=16, truncation_k=16, block_size=64)
    lb = fit_thresholds(params_from_jax(params, device="cpu"), inv)
    tracer, plog = Tracer(), ProbeLog()
    cfg = ServeConfig(n_shards=2, device="cpu", obs=dict(trace=tracer, probe_log=plog))
    eng = BooleanEngine(lb, inv, li, cfg)
    bool_q = sample_queries(corpus, 8, seed=3)
    ranked_q, _ = zipf_disjunctions(inv.dfs, 8, seed=5)
    eng.query_batch(bool_q)
    eng.query_topk(ranked_q, 5)
    return eng, tracer, plog, bool_q


def test_traced_batch_covers_every_phase(served):
    _, tracer, _, _ = served
    names = {s.name for s in tracer.spans}
    # boolean path: plan -> per-shard mask -> probe fan-out -> merge
    assert {"serve.batch", "serve.plan", "serve.candidate_mask",
            "serve.probe_phase", "shard.verify", "probe.term",
            "serve.merge"} <= names
    # ranked path: plan -> per-shard topk -> heap merge
    assert {"serve.topk_batch", "shard.topk", "serve.heap_merge"} <= names
    # probe spans carry the route decision + candidate count as attrs
    probes = [s for s in tracer.spans if s.name == "probe.term"]
    assert probes and all(
        {"term", "route", "n_cands"} <= set(s.attrs) for s in probes
    )
    # the port verifies term-major: one shard.verify span per round
    verify = [s for s in tracer.spans if s.name == "shard.verify"]
    assert all({"queries", "candidates", "results"} <= set(s.attrs) for s in verify)


def test_one_probe_record_per_routed_probe(served):
    eng, _, plog, _ = served
    g = eng.metrics.snapshot()["guided"]
    recs = plog.records
    # every non-empty probe call bumps exactly one route counter and logs
    # exactly one record
    routed = sum(1 for r in recs if r.route != "empty")
    assert routed == g["guided_terms"] + g["fallback_terms"] + g["routed_terms"]
    assert plog.n_records == len(recs) > 0
    # executor context attributes every record to a live (query, shard)
    assert all(r.query >= 0 and r.shard in (0, 1) for r in recs)
    assert all(r.route in ("empty", "fallback", "decode", "guided") for r in recs)
    assert all(r.wall_us >= 0.0 and r.bytes >= 0 for r in recs)


def test_serving_stats_is_a_deprecated_snapshot_alias(served):
    eng, *_ = served
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        legacy = eng.serving_stats()
        eng.serving_stats()  # exactly one warning per call, not per process
    deps = [x for x in w if issubclass(x.category, DeprecationWarning)]
    assert len(deps) == 2
    snap = eng.metrics.snapshot()
    assert legacy.keys() == snap.keys()
    assert legacy["summary"] == snap["summary"]
    # the summary block keeps the reference's keys exactly
    assert set(legacy["summary"]) == {
        "n_shards", "cache_hits", "cache_misses", "cache_evictions",
        "probe_bytes", "bytes_ratio", "scored_fraction",
    }
    # facade summary aggregates the per-shard registries
    assert legacy["summary"]["cache_hits"] == sum(
        s["decode_cache"]["hits"] for s in legacy["shards"]
    )
    assert legacy["queries"]["boolean"] == 8 and legacy["queries"]["ranked"] == 8
    for name in ("plan_us", "mask_us", "probe_us", "merge_us", "query_us",
                 "topk_query_us"):
        assert legacy["latency"][name]["count"] > 0, name


def test_trace_off_records_nothing(served):
    eng, tracer, _, bool_q = served
    n = len(tracer.spans)
    saved = eng.cfg.trace
    eng.cfg.trace = None
    try:
        eng.query_batch(bool_q[:2])
    finally:
        eng.cfg.trace = saved
    assert len(tracer.spans) == n


def test_public_reset_clears_every_window(served):
    eng, _, _, bool_q = served
    eng.query_batch(bool_q[:2])
    # per-shard public reset: no caller reaches into sh._guided
    for sh in eng.shards:
        assert hasattr(sh, "reset_stats")
    eng.reset_stats()
    snap = eng.metrics.snapshot()
    assert "ranked" not in snap  # ranked section reappears only after queries
    assert snap["summary"]["cache_hits"] == 0
    assert snap["summary"]["probe_bytes"] == 0
    assert snap["queries"] == {"ranked": 0, "boolean": 0}
    assert "latency" not in snap or all(
        v is None for v in snap["latency"].values()
    )


# ---------------------------------------------------------------- parity
def test_histogram_and_registry_snapshots_equal_reference():
    """Same observations, same buckets: identical snapshots (percentiles
    compared exactly)."""
    from repro.obs import Histogram as RefHistogram
    from repro.obs import Registry as RefRegistry

    rng = np.random.default_rng(11)
    values = np.clip(rng.lognormal(np.log(300.0), 1.5, size=3000), 0.5, 5e7)
    for buckets in (None, list(np.arange(0.0, 2000.0, 25.0))):
        h, rh = Histogram(buckets), RefHistogram(buckets)
        for v in values:
            h.observe(v)
            rh.observe(v)
        assert h.snapshot() == rh.snapshot()
        for q in (0, 1, 5, 50, 90, 99, 99.9, 100):
            assert h.percentile(q) == rh.percentile(q)
    regs = (Registry(), RefRegistry())
    for reg in regs:
        reg.counter("sched.batches").inc(7)
        reg.gauge("sched.queue_depth").set(3.0)
        for v in values[:500]:
            reg.histogram("latency.query_us").observe(v)
        reg.register("summary", lambda: {"n_shards": 2})
        reg.register("ranked", lambda: None)
    assert regs[0].snapshot() == regs[1].snapshot()


def test_probe_log_files_read_across_packages(tmp_path):
    """A JSONL probe log written by either package reads back in the other,
    record for record."""
    from repro.obs import ProbeLog as RefProbeLog

    rng = np.random.default_rng(3)
    rows = [dict(term=int(rng.integers(0, 1000)), route=str(rng.choice(
        ["guided", "decode", "fallback", "empty"])), n_cands=int(rng.integers(0, 500)),
        n_found=int(rng.integers(0, 50)), n_postings=int(rng.integers(1, 9000)),
        eps_window=float(rng.random() * 40), bytes=int(rng.integers(0, 4096)),
        wall_us=float(rng.random() * 100)) for _ in range(40)]
    for writer, reader in ((ProbeLog, RefProbeLog), (RefProbeLog, ProbeLog)):
        path = str(tmp_path / f"{writer.__module__}.jsonl")
        log = writer(path)
        for i, row in enumerate(rows):
            with log.context(query=i % 5, shard=i % 3):
                log.log(**row)
        log.close()
        with open(path) as f:
            text = f.read()
        back = reader.read(path)
        assert [vars(r) for r in back] == [vars(r) for r in writer.read(path)]
        assert "".join(r.to_json() + "\n" for r in back) == text


def _record_key(r):
    return (r.query, r.shard, r.term, r.route, r.n_cands, r.n_found, r.eps_window, r.bytes)


def test_engine_probe_records_and_sections_equal_reference():
    """The same Boolean and ranked batches through both engines (the same
    collection, parameters and thresholds): the probe-record multisets
    (``wall_us`` and order aside) and the ``guided``, ``summary`` and
    ``queries`` sections are equal, and the port's span names cover the
    reference's."""
    import jax.numpy as jnp

    from repro.common.config import LearnedIndexConfig as RefLIConfig
    from repro.core.learned_bloom import LearnedBloom as RefLearnedBloom
    from repro.obs import ProbeLog as RefProbeLog
    from repro.obs import Tracer as RefTracer
    from repro.serve import BooleanEngine as RefEngine
    from repro.serve import ServeConfig as RefServeConfig

    corpus, inv, params = _collection()
    lb = fit_thresholds(params_from_jax(params, device="cpu"), inv)
    ref_lb = RefLearnedBloom(
        params={"term_embed": {"table": jnp.asarray(params["term_embed"]["table"])},
                "doc_embed": {"table": jnp.asarray(params["doc_embed"]["table"])},
                "bias": jnp.asarray(params["bias"])},
        tau=lb.tau.numpy(), backup_keys=np.zeros(0, np.int64), n_docs=inv.n_docs)
    tr, plog, ref_tr, ref_plog = Tracer(), ProbeLog(), RefTracer(), RefProbeLog()
    ranked = dict(topk_exhaustive_cutoff=0)  # MaxScore probes, not only full decodes
    eng = BooleanEngine(lb, inv, LearnedIndexConfig(embed_dim=16, truncation_k=16, block_size=64),
                        ServeConfig(n_shards=2, device="cpu", ranked=ranked,
                                    obs=dict(trace=tr, probe_log=plog)))
    ref = RefEngine(ref_lb, inv, RefLIConfig(embed_dim=16, truncation_k=16, block_size=64),
                    RefServeConfig(n_shards=2, ranked=ranked,
                                   obs=dict(trace=ref_tr, probe_log=ref_plog)))
    bool_q = np.concatenate([sample_queries(corpus, 24, seed=3),
                             zipf_conjunctions(inv.dfs, 16, seed=4)])
    ranked_q, _ = zipf_disjunctions(inv.dfs, 8, seed=5)
    for e in (eng, ref):
        e.query_batch(bool_q)
    n, n_ref = plog.n_records, ref_plog.n_records
    assert n == n_ref > 0
    assert (collections.Counter(map(_record_key, plog.records))
            == collections.Counter(map(_record_key, ref_plog.records)))
    for e in (eng, ref):
        e.query_topk(ranked_q, 5)
    assert plog.n_records - n == ref_plog.n_records - n_ref > 0
    assert (collections.Counter(map(_record_key, plog.records[n:]))
            == collections.Counter(map(_record_key, ref_plog.records[n_ref:])))
    snap, ref_snap = eng.metrics.snapshot(), ref.metrics.snapshot()
    # the port's guided section adds its wide-window counters
    assert {k: snap["guided"][k] for k in ref_snap["guided"]} == ref_snap["guided"]
    assert snap["summary"] == ref_snap["summary"]
    assert snap["queries"] == ref_snap["queries"]
    assert {s.name for s in ref_tr.spans} <= {s.name for s in tr.spans}


def test_batched_verify_probe_records_equal_reference_on_learned_lists():
    """A shard whose tier-2 holds learned (plm/rmi) and classical lists:
    the port verifies a batch term-major, one guided launch a round, the
    reference query after query; the records (query, shard, term, route,
    candidates, found, ε-window, bytes) are the same multiset, planned or
    not, with the decode cache holding everything or evicting."""
    import jax.numpy as jnp

    from repro.common.config import LearnedIndexConfig as RefLIConfig
    from repro.core.learned_bloom import LearnedBloom as RefLearnedBloom
    from repro.obs import ProbeLog as RefProbeLog
    from repro.postings import HybridPostings as RefHybridPostings
    from repro.serve import ServeConfig as RefServeConfig
    from repro.serve.shard import ShardEngine as RefShardEngine
    from repro_torch.postings import HybridPostings
    from repro_torch.serve.shard import ShardEngine

    corpus = synthesize_corpus(CorpusConfig(n_docs=400, n_terms=1600, avg_doc_len=50, seed=31))
    inv = build_inverted_index(corpus)
    rng = np.random.default_rng(9)
    params = {"term_embed": {"table": (rng.standard_normal((1600, 16)) * 0.3).astype(np.float32)},
              "doc_embed": {"table": (rng.standard_normal((400, 16)) * 0.3).astype(np.float32)},
              "bias": np.float32(0.0)}
    lb = fit_thresholds(params_from_jax(params, device="cpu"), inv)
    ref_lb = RefLearnedBloom(
        params={"term_embed": {"table": jnp.asarray(params["term_embed"]["table"])},
                "doc_embed": {"table": jnp.asarray(params["doc_embed"]["table"])},
                "bias": jnp.asarray(params["bias"])},
        tau=lb.tau.numpy(), backup_keys=np.zeros(0, np.int64), n_docs=inv.n_docs)
    # long smooth lists (a learned codec wins) and every fourth a random one
    terms = [int(t) for t in np.argsort(-inv.dfs, kind="stable")[:12]]
    universe = 1 << 20
    rng = np.random.default_rng(41)
    lists = [np.zeros(0, np.int32)] * inv.n_terms
    for i, t in enumerate(terms):
        n = 4000 // (i + 1) + 300
        if i % 4 == 3:
            ids = rng.choice(universe, n, replace=False)
        else:
            slope = int(rng.integers(16, 200))
            ids = int(rng.integers(0, universe // 2)) + np.arange(n) * slope \
                + rng.integers(0, slope // 4, n)
        lists[t] = np.unique(ids).astype(np.int32)
    offsets = np.zeros(inv.n_terms + 1, np.int64)
    np.cumsum([len(x) for x in lists], out=offsets[1:])
    flat = np.concatenate(lists)
    store = HybridPostings.build(offsets, flat, universe)
    ref_store = RefHybridPostings.build(offsets, flat, universe)
    jobs = []
    for q in range(20):
        ts = sorted(rng.choice(terms, int(rng.integers(2, 6)), replace=False),
                    key=lambda t: len(lists[t]))
        cands = np.union1d(rng.choice(lists[ts[0]], 60), rng.integers(0, universe, 60))
        routes = {int(ts[-1]): "decode"} if q % 5 == 4 else None
        jobs.append((tuple(int(t) for t in ts), cands.astype(np.int32), routes))
    li = LearnedIndexConfig(embed_dim=16, truncation_k=16, block_size=64)
    ref_li = RefLIConfig(embed_dim=16, truncation_k=16, block_size=64)
    for planned in (True, False):
        for budget in (32 << 20, 6000):
            plog, ref_plog = ProbeLog(), RefProbeLog()
            sh = ShardEngine(lb, inv, li, ServeConfig(
                device="cpu", cache_budget_bytes=budget, obs=dict(probe_log=plog)), tier2=store)
            ref_sh = RefShardEngine(ref_lb, inv, ref_li, RefServeConfig(
                cache_budget_bytes=budget, obs=dict(probe_log=ref_plog)), tier2=ref_store)
            if planned:  # the planner's route decisions parse (and charge) the models
                for t in terms:
                    assert sh.route_term(t, 10) == ref_sh.route_term(t, 10)
            got = sh._verify_batch(jobs)
            for i, (ts, cands, routes) in enumerate(jobs):
                with ref_plog.context(query=i, shard=0):
                    want = ref_sh._verify_terms(ts, cands, routes)
                assert np.array_equal(got[i], want)
            assert {r.route for r in plog.records} == {"guided", "decode", "fallback"}
            assert (collections.Counter(map(_record_key, plog.records))
                    == collections.Counter(map(_record_key, ref_plog.records))), (planned, budget)
            assert [r.query for r in plog.records] == sorted(r.query for r in plog.records)
