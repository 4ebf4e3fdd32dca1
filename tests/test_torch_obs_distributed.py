"""Distributed tracing + SLO telemetry in the port (repro_torch.obs collate,
slo, export) against the reference's ``tests/test_obs_distributed.py``,
case for case, plus parity cases.

The unit half pins the primitives in isolation: min-RTT clock-offset
estimation against a skewed fake clock, wire-span rebasing onto the host
epoch, the per-lane nesting invariant checker, the sliding-window SLO
monitor's hit-rate/burn-rate math, Prometheus text rendering, probe-log
size-capped rotation and drain/ingest forwarding, and the histogram
snapshot/reset race under writer threads.

The integration half runs real spawned process replicas on the CPU: worker
spans must merge into the host tracer time-aligned (own pid lanes, no
partial overlaps, trace_id threaded through), worker probe records must
land in the host sink, a crashed-then-respawned replica must re-sync its
clock offset, and ``QueryResult.autopsy()`` / ``Session.slo_report()`` must
decompose where the latency went.  The parity cases import both packages:
``render_prometheus`` gives byte-identical text for one snapshot,
``SLOMonitor.report()`` equal reports under one injected clock, and wire
spans drained by either package's tracer land the same in the other's.
"""
import json
import os
import tempfile
import threading
import time

import numpy as np
import pytest

from repro_torch.common.config import CorpusConfig, LearnedIndexConfig
from repro_torch.core.learned_bloom import fit_thresholds
from repro_torch.core.membership import params_from_jax
from repro_torch.data.corpus import synthesize_corpus
from repro_torch.data.queries import sample_queries, zipf_conjunctions
from repro_torch.index.build import build_inverted_index
from repro_torch.obs import (
    Histogram,
    ProbeLog,
    SLOMonitor,
    TraceContext,
    Tracer,
    estimate_clock_offset,
    ingest_worker_spans,
    nesting_violations,
    render_prometheus,
    write_prometheus,
)
from repro_torch.obs.trace import Span
from repro_torch.serve import BooleanEngine, QueryRequest, Rejected, ServeConfig, Session
from repro_torch.serve.sched import MODE_RANKED, WorkerFailure

SPAWN_TIMEOUT_S = 45.0  # a replica that never answers fails its test, not the run


# ------------------------------------------------------------- clock offset
def test_clock_offset_recovers_known_skew():
    skew_ns = 5_000_000_000  # 5 s: far above any measurement error

    def roundtrip():
        return time.perf_counter_ns() + skew_ns

    offset, rtt = estimate_clock_offset(roundtrip)
    assert rtt >= 0
    # symmetric-delay bound: the estimate is within RTT/2 of the true skew
    assert abs(offset - skew_ns) <= rtt / 2 + 1_000

    with pytest.raises(ValueError):
        estimate_clock_offset(roundtrip, n=0)


def test_clock_offset_keeps_min_rtt_sample():
    # one fast exchange among slow ones: its (accurate) offset must win
    calls = {"n": 0}

    def roundtrip():
        calls["n"] += 1
        if calls["n"] != 3:
            time.sleep(0.005)  # slow ping: midpoint assumption is off
            return time.perf_counter_ns() + 10_000_000
        return time.perf_counter_ns() + 10_000_000

    offset, rtt = estimate_clock_offset(roundtrip, n=5)
    assert calls["n"] == 5
    assert rtt < 5_000_000  # the fast sample's RTT, not a slept one's
    assert abs(offset - 10_000_000) <= rtt / 2 + 1_000


# --------------------------------------------------------------- wire spans
def test_wire_span_round_trip_rebases_onto_host_epoch():
    host, worker = Tracer(name="host"), Tracer(name="w")
    with worker.activate(), worker.span("worker.op", trace_id=7):
        time.sleep(0.001)
    [orig] = worker.spans
    wire = worker.drain_wire()
    assert worker.spans == []  # drained, epoch kept
    assert wire[0]["name"] == "worker.op" and wire[0]["attrs"] == {"trace_id": 7}

    # both tracers run on this process's clock, so the true offset is 0
    n = ingest_worker_spans(host, wire, offset_ns=0, pid=4242, label="replica")
    assert n == 1
    [merged] = host.spans
    assert merged.pid == 4242 and merged.name == "worker.op"
    # rebasing: worker-epoch-relative ts shifted by the epoch gap
    want_ts = (worker.epoch_ns - host.epoch_ns) / 1e3 + orig.ts_us
    assert abs(merged.ts_us - want_ts) < 0.5
    assert abs(merged.dur_us - orig.dur_us) < 1e-9

    doc = host.chrome_trace()
    lanes = {e["pid"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert lanes == {4242}
    assert {"name": "process_name", "ph": "M", "pid": 4242, "tid": 0,
            "args": {"name": "replica"}} in doc["traceEvents"]


def _span(name, ts, dur, *, pid=0, tid=0):
    return Span(name=name, ts_us=ts, dur_us=dur, tid=tid, depth=0, attrs={},
                pid=pid)


def test_nesting_violations_flags_partial_overlap_only():
    nested = [_span("a", 0, 100), _span("b", 10, 50), _span("c", 20, 10)]
    disjoint = [_span("d", 200, 50), _span("e", 300, 50)]
    assert nesting_violations(nested + disjoint) == []
    # partial overlap: starts inside `b`, ends beyond it (reported against
    # the innermost still-open span)
    bad = nesting_violations(nested + [_span("x", 50, 100)])
    assert len(bad) == 1 and "'x'" in bad[0] and "'b'" in bad[0]
    # the same intervals on different lanes never interact
    assert nesting_violations(nested + [_span("x", 50, 100, pid=9)]) == []
    assert nesting_violations(nested + [_span("x", 50, 100, tid=9)]) == []
    # sub-slack overhang is tolerated (shared endpoints from float math)
    assert nesting_violations(
        [_span("a", 0, 100), _span("b", 50, 50.3)], slack_us=0.5
    ) == []


# ----------------------------------------------------------------- monitor
def test_slo_monitor_hit_rate_percentiles_and_burn():
    t = {"now": 0.0}
    slo = SLOMonitor(window_s=10.0, target=0.9, clock=lambda: t["now"])
    for i in range(8):
        slo.record("a", latency_us=1000.0 * (i + 1), served=True,
                   deadline_met=True)
    slo.record("a", latency_us=50_000.0, served=True, deadline_met=False)
    slo.record("a", latency_us=0.0, served=False, deadline_met=False)  # shed
    rep = slo.report()["a"]
    assert rep["requests"] == 10 and rep["served"] == 9 and rep["shed"] == 1
    assert rep["deadline_hit_rate"] == pytest.approx(0.8)
    # 20% misses against a 10% budget: burning at 2x sustainable
    assert rep["burn_rate"] == pytest.approx(2.0)
    lat_ms = sorted([1, 2, 3, 4, 5, 6, 7, 8, 50])
    assert rep["p50_ms"] == pytest.approx(float(np.percentile(lat_ms, 50)))
    assert rep["p99_ms"] == pytest.approx(float(np.percentile(lat_ms, 99)))

    # the window slides: everything above ages out
    t["now"] = 11.0
    slo.record("b", latency_us=500.0, served=True, deadline_met=True)
    rep = slo.report()
    assert "a" not in rep and rep["b"]["requests"] == 1

    slo.reset()
    assert slo.report() == {}
    with pytest.raises(ValueError):
        SLOMonitor(target=1.0)


def test_slo_monitor_bounds_memory_per_tenant():
    slo = SLOMonitor(window_s=1e9, max_samples_per_tenant=16)
    for _ in range(100):
        slo.record("hot", latency_us=1.0, served=True, deadline_met=True)
    assert slo.report()["hot"]["requests"] == 16


# ---------------------------------------------------------------- exporter
def test_render_prometheus_text_exposition():
    h = Histogram()
    for v in (1.0, 2.0, 3.0, 4.0):
        h.observe(v)
    text = render_prometheus({
        "sched": {"shed": {"deadline": 2}, "service_us": h.snapshot()},
        "queries": {"boolean": 7},
        "sweep": {"p99": [1.5, 2.5]},
        "meta": {"note": "strings are skipped", "none": None},
    })
    lines = text.splitlines()
    assert "repro_queries_boolean 7" in lines
    assert "repro_sched_shed_deadline 2" in lines
    assert 'repro_sweep_p99{idx="0"} 1.5' in lines
    assert 'repro_sweep_p99{idx="1"} 2.5' in lines
    assert "repro_sched_service_us_count 4" in lines
    assert 'repro_sched_service_us{quantile="0.5"}' in text
    assert "note" not in text and "none" not in text
    # each metric gets exactly one TYPE line, and the doc is sorted/stable
    types = [line for line in lines if line.startswith("# TYPE")]
    assert len(types) == len(set(types))
    assert text == render_prometheus({
        "meta": {"note": "strings are skipped", "none": None},
        "sweep": {"p99": [1.5, 2.5]},
        "queries": {"boolean": 7},
        "sched": {"service_us": h.snapshot(), "shed": {"deadline": 2}},
    })

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.prom")
        write_prometheus({"queries": {"boolean": 7}}, path)
        with open(path) as f:
            assert "repro_queries_boolean 7" in f.read()


# ---------------------------------------------------------------- probe log
def _probe(log, term=1):
    log.log(term, "guided", n_cands=4, n_found=2, n_postings=64,
            eps_window=1.0, bytes=32, wall_us=2.0)


def test_probelog_rotates_at_size_cap():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "probes.jsonl")
        log = ProbeLog(path, max_bytes=2048)
        for i in range(200):
            _probe(log, term=i)
        log.close()
        assert log.n_rotations >= 1
        assert os.path.exists(path) and os.path.exists(path + ".1")
        # disk held at <= ~2x the cap regardless of how much was logged
        assert os.path.getsize(path) <= 2 * 2048
        assert os.path.getsize(path + ".1") <= 2 * 2048
        # both generations stay valid JSONL
        kept = ProbeLog.read(path) + ProbeLog.read(path + ".1")
        assert 0 < len(kept) <= 200
        assert all(r.route == "guided" for r in kept)


def test_probelog_drain_ingest_forwarding():
    worker = ProbeLog()  # in-memory worker-side sink
    with worker.context(query=3, shard=1):
        _probe(worker, term=17)
    wire = worker.drain()
    assert worker.records == []  # buffer drained (n_records stays lifetime)
    assert worker.n_records == 1
    assert isinstance(wire[0], dict) and wire[0]["term"] == 17

    host = ProbeLog()
    host.ingest(wire)
    [rec] = host.records
    assert (rec.query, rec.shard, rec.term) == (3, 1, 17)
    # None inherits the enclosing half: per-query facade context + per-shard
    # executor context compose without clobbering each other
    with host.context(query=9, shard=None), host.context(query=None, shard=4):
        _probe(host, term=5)
    assert (host.records[-1].query, host.records[-1].shard) == (9, 4)


# ---------------------------------------------------------------- histogram
def test_histogram_snapshot_reset_race():
    """Writers hammer observe() while a reader snapshots/resets: every
    snapshot must be internally consistent (one locked view, not a torn
    read across reset)."""
    h = Histogram()
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            h.observe(5.0)

    threads = [threading.Thread(target=writer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(300):
            s = h.snapshot()
            if s is None:
                continue  # consistent empty view right after a reset
            assert s["count"] >= 1
            assert s["min"] == s["max"] == 5.0
            assert s["mean"] == pytest.approx(5.0)
            assert s["sum"] == pytest.approx(5.0 * s["count"])
            h.reset()
    finally:
        stop.set()
        for t in threads:
            t.join()


# ------------------------------------------------------------- integration
@pytest.fixture(scope="module")
def system():
    """The reference test's collection (400 docs, 1600 terms, seed 31) with
    membership parameters made with numpy from a seed."""
    corpus = synthesize_corpus(CorpusConfig(n_docs=400, n_terms=1600, avg_doc_len=50, seed=31))
    inv = build_inverted_index(corpus)
    rng = np.random.default_rng(2)
    params = {
        "term_embed": {"table": (rng.standard_normal((1600, 16)) * 0.3).astype(np.float32)},
        "doc_embed": {"table": (rng.standard_normal((400, 16)) * 0.3).astype(np.float32)},
        "bias": np.float32(0.0),
    }
    li_cfg = LearnedIndexConfig(embed_dim=16, truncation_k=16, block_size=64)
    lb = fit_thresholds(params_from_jax(params, device="cpu"), inv)
    return corpus, inv, li_cfg, lb


def _cfg(**kw):
    sched = dict(kw.pop("sched", {}))
    sched.setdefault("spawn_timeout_s", SPAWN_TIMEOUT_S)
    return ServeConfig(device="cpu", sched=sched, **kw)


def test_worker_spans_merge_time_aligned(system, tmp_path):
    """The tentpole end to end: a ranked + boolean request through a real
    process replica produces ONE coherent timeline — worker spans on their
    own pid lane, clock-aligned, nested, carrying the request's trace_id."""
    corpus, inv, li_cfg, lb = system
    tracer, plog = Tracer(), ProbeLog()
    cfg = _cfg(n_shards=2, sched=dict(n_replicas=1), obs=dict(trace=tracer, probe_log=plog))
    eng = BooleanEngine(lb, inv, li_cfg, cfg)
    q = sample_queries(corpus, 4, max_terms=4, seed=5)
    rq = zipf_conjunctions(inv.dfs, 4, max_terms=4, seed=9)
    with Session(eng, store_dir=str(tmp_path)) as s:
        s.warm()
        tracer.reset()  # only the traced requests below, not warmup
        t0_us = (time.perf_counter_ns() - tracer.epoch_ns) / 1e3
        r = s.submit(QueryRequest(terms=q[0]), timeout=30)
        rr = s.submit(QueryRequest(terms=rq[0], mode=MODE_RANKED, k=5), timeout=30)
        assert r.ok and rr.ok
        t1_us = (time.perf_counter_ns() - tracer.epoch_ns) / 1e3
        pids = {rep.pid for g in s._groups for rep in g.replicas}

    host = [s_ for s_ in tracer.spans if s_.pid == 0]
    worker = [s_ for s_ in tracer.spans if s_.pid != 0]
    assert host and worker
    assert {s_.pid for s_ in worker} <= pids
    wnames = {s_.name for s_ in worker}
    assert "worker.bool" in wnames and "worker.topk" in wnames
    assert "shard.candidate_mask" in wnames  # probe work happened worker-side
    assert {"kernel.membership", "kernel.bitset"} <= wnames  # the candidate step's launches
    # host side still owns admission + dispatch + merge
    hnames = {s_.name for s_ in host}
    assert {"sched.queue_wait", "sched.batch", "sched.dispatch",
            "sched.merge"} <= hnames

    # time alignment: every merged worker span lands inside the wall window
    # of the two requests as seen on the HOST clock (offset applied), and
    # lanes are stack-consistent after the mapping
    for s_ in worker:
        assert t0_us - 1e3 <= s_.ts_us <= s_.ts_us + s_.dur_us <= t1_us + 1e3
    assert nesting_violations(tracer.spans, slack_us=0.5) == []

    # the request's trace_id threads through to the worker-root spans
    roots = [s_ for s_ in worker if s_.name in ("worker.bool", "worker.topk")]
    assert roots and all(s_.attrs.get("trace_id", 0) > 0 for s_ in roots)

    # worker probe records were forwarded into the host sink
    assert plog.n_records > 0
    assert all(r_.shard in (0, 1) for r_ in plog.records)

    # the exported artifact names each replica lane
    doc = tracer.chrome_trace()
    lane_names = {e["args"]["name"] for e in doc["traceEvents"]
                  if e["ph"] == "M" and e["name"] == "process_name"}
    assert any(n.startswith("shard") for n in lane_names)
    json.dumps(doc)


def test_respawned_replica_resyncs_clock(system, tmp_path):
    corpus, inv, li_cfg, lb = system
    eng = BooleanEngine(lb, inv, li_cfg, _cfg(n_shards=1, sched=dict(n_replicas=1)))
    with Session(eng, store_dir=str(tmp_path)) as s:
        s.warm()
        [group] = s._groups
        [rep] = group.replicas
        pid0, syncs0 = rep.pid, rep.clock_syncs
        assert syncs0 >= 1 and rep.clock_offset_ns is not None
        assert rep.clock_rtt_ns >= 0
        with pytest.raises(WorkerFailure):
            group.call(("crash",))  # crash + respawned retry crashes again
        assert group.call(("ping",)) == "pong"  # respawns once more
        assert rep.pid not in (None, pid0)
        # every (re)spawn re-ran the ping sync: offset is fresh, not stale
        assert rep.clock_syncs == syncs0 + 2
        assert rep.clock_offset_ns is not None


def test_autopsy_and_slo_report_inline(system):
    corpus, inv, li_cfg, lb = system
    eng = BooleanEngine(lb, inv, li_cfg, _cfg(n_shards=1))
    q = sample_queries(corpus, 4, max_terms=4, seed=5)
    with Session(eng) as s:
        r = s.submit(QueryRequest(terms=q[0]), timeout=10)
        assert r.ok and r.phases is not None
        a = r.autopsy()
        assert a["total_us"] == pytest.approx(r.queue_us + r.service_us)
        assert a["execute_us"] > 0.0
        for k in ("queue", "dispatch", "execute", "merge"):
            assert a[f"{k}_us"] >= 0.0
            assert 0.0 <= a[f"{k}_frac"] <= 1.0
        # phase walls are measured inside the service window
        assert (a["dispatch_us"] + a["execute_us"] + a["merge_us"]
                <= r.service_us * 1.01 + 1.0)

        # one shed outcome: an already-expired deadline
        shed = s.submit(QueryRequest(terms=q[1], deadline_ms=-1.0), timeout=10)
        assert isinstance(shed, Rejected)

        rep = s.slo_report()
    assert rep["window_s"] > 0 and 0 < rep["target"] < 1
    ten = rep["tenants"]["default"]
    assert ten["requests"] == 2 and ten["served"] == 1 and ten["shed"] == 1
    assert ten["deadline_hit_rate"] == pytest.approx(0.5)
    assert ten["burn_rate"] > 1.0  # half the window missed: budget burning
    assert {"queue_us", "service_us", "dispatch_us", "execute_us",
            "merge_us"} <= set(rep["sched"])


def test_short_circuit_results_have_autopsy_defaults():
    from repro_torch.serve.sched.api import QueryResult

    qr = QueryResult(ids=np.zeros(0, np.int32), queue_us=0.0, service_us=0.0)
    a = qr.autopsy()  # phases=None: a short-circuit never saw a batch
    assert a["total_us"] == 0.0 and a["execute_frac"] == 0.0


def test_trace_context_pickles_and_defaults():
    import pickle

    ctx = TraceContext(trace_id=5, trace=True, probe=False)
    back = pickle.loads(pickle.dumps(ctx))
    assert back == ctx and back.trace_id == 5
    assert TraceContext() == TraceContext(trace_id=0, trace=False, probe=False)


# ---------------------------------------------------------------- parity
def test_render_prometheus_byte_identical_to_reference():
    """One snapshot (histogram summaries, counters, lists, booleans,
    strings, None) renders to the same bytes in both packages."""
    from repro.obs import Histogram as RefHistogram
    from repro.obs import render_prometheus as ref_render

    h, rh = Histogram(), RefHistogram()
    for v in np.random.default_rng(4).lognormal(5.0, 1.2, 400):
        h.observe(v)
        rh.observe(v)
    assert h.snapshot() == rh.snapshot()
    snap = {
        "sched": {"shed": {"deadline": 2, "queue_full": 0}, "service_us": h.snapshot(),
                  "queue_depth": 3.0, "batches": 12},
        "queries": {"boolean": 7, "ranked": 0},
        "shards": [{"decode_cache": {"hits": 4, "misses": 1}, "range": {"lo": 0, "hi": 224}},
                   {"decode_cache": {"hits": 2, "misses": 3}, "range": {"lo": 224, "hi": 400}}],
        "guided": {"bytes_ratio": 0.125, "wide": True},
        "meta": {"note": "skipped", "none": None},
    }
    for prefix in ("repro", "svc"):
        assert render_prometheus(snap, prefix=prefix) == ref_render(snap, prefix=prefix)


def test_slo_report_equal_to_reference_under_one_clock():
    from repro.obs import SLOMonitor as RefSLOMonitor

    t = {"now": 0.0}
    mons = [cls(window_s=5.0, target=0.95, max_samples_per_tenant=64, clock=lambda: t["now"])
            for cls in (SLOMonitor, RefSLOMonitor)]
    rng = np.random.default_rng(8)
    for step in range(400):
        t["now"] = step * 0.05
        tenant = f"t{int(rng.integers(0, 3))}"
        served = bool(rng.random() < 0.9)
        lat = float(rng.lognormal(8.0, 1.0))
        met = served and bool(rng.random() < 0.93)
        for m in mons:
            m.record(tenant, latency_us=lat, served=served, deadline_met=met)
        if step % 50 == 49:
            assert mons[0].report() == mons[1].report()
    assert mons[0].report() == mons[1].report() and mons[0].report()


def test_wire_spans_cross_between_packages():
    """A worker tracer of either package drains wire spans that the other
    package's host tracer ingests to the same spans and the same Chrome
    trace events."""
    from repro.obs import Tracer as RefTracer
    from repro.obs import ingest_worker_spans as ref_ingest

    for worker_cls in (Tracer, RefTracer):
        worker = worker_cls(name="w")
        with worker.activate():
            with worker.span("worker.bool", trace_id=3):
                with worker.span("kernel.membership", slots=5):
                    time.sleep(0.0005)
        wire = worker.drain_wire()
        hosts = (Tracer(name="host"), RefTracer(name="host"))
        hosts[1].epoch_ns = hosts[0].epoch_ns
        assert ingest_worker_spans(hosts[0], wire, offset_ns=123, pid=77, label="shard0") == 2
        assert ref_ingest(hosts[1], wire, offset_ns=123, pid=77, label="shard0") == 2
        assert [vars(s) for s in hosts[0].spans] == [vars(s) for s in hosts[1].spans]
        docs = [h.chrome_trace() for h in hosts]
        assert docs[0]["traceEvents"] == docs[1]["traceEvents"]
        assert nesting_violations(hosts[0].spans) == []


def test_queue_wait_spans_keep_lanes_nested_under_concurrent_batches(system):
    """Many single requests from several client threads, served inline in
    coalesced batches while others wait: every lane of the trace stays
    nested or disjoint (each admission wait has a lane of its own; on the
    runner thread's lane, where the reference puts it, a wait overlaps the
    batch that thread ran meanwhile)."""
    corpus, inv, li_cfg, lb = system
    tracer = Tracer()
    eng = BooleanEngine(lb, inv, li_cfg, _cfg(n_shards=2, obs=dict(trace=tracer)))
    q = sample_queries(corpus, 64, max_terms=4, seed=6)
    outs = [None] * len(q)
    with Session(eng) as s:
        def client(c):
            futs = [(i, s.submit_async(QueryRequest(terms=q[i], tenant=f"c{c}")))
                    for i in range(c, len(q), 4)]
            for i, f in futs:
                outs[i] = f.result(timeout=60)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    want = eng.query_batch(q)
    assert all(o.ok and np.array_equal(o.ids, w) for o, w in zip(outs, want))
    waits = [sp for sp in tracer.spans if sp.name == "sched.queue_wait"]
    assert len(waits) == len(q) and len({sp.tid for sp in waits}) == len(q)
    assert eng.metrics.snapshot()["sched"]["batches"] < len(q)  # requests coalesced
    assert nesting_violations(tracer.spans, slack_us=0.5) == []


def test_launcher_serves_through_process_replicas_on_cpu(tmp_path, capsys):
    """The launcher's scheduler flags: one process replica per shard, a
    Chrome trace with worker lanes, a probe log, the SLO report."""
    from repro_torch.launch.serve import main as serve_main

    trace_path, probe_path = tmp_path / "t.json", tmp_path / "p.jsonl"
    serve_main(["--device", "cpu", "--docs", "400", "--terms", "1600", "--queries", "12",
                "--train-steps", "5", "--shards", "2", "--topk", "0", "--replicas", "1",
                "--index-dir", str(tmp_path / "idx"), "--trace-out", str(trace_path),
                "--probe-log", str(probe_path), "--slo"])
    out = capsys.readouterr().out
    assert "parity-with-facade=12/12" in out and "SLO report" in out
    assert "replica lane(s)" in out and "repro_sched_batch_size" in out
    doc = json.loads(trace_path.read_text())
    lanes = {e["pid"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert 0 in lanes and len(lanes) == 3  # the host and one lane per worker
    assert ProbeLog.read(str(probe_path))
