"""The port's continuous-batching scheduler (serve/sched) against the
reference's ``tests/test_sched.py``, case for case, plus parity cases.

Covers the scheduler's acceptance edges on the CPU (``device="cpu"``, the
kernels' plain versions): legacy-wrapper bit-parity (inline and through real
spawned process workers), queue saturation shedding lowest-priority first,
expired deadlines never reaching a worker, crash retry-once-then-typed-error
(fakes and the real process crash hook), all-pad short-circuits, tenant
quotas, same-mode batch coalescing and the ServeConfig legacy-kwarg shim.
The parity cases hold the port to the reference: ``AdmissionQueue`` sheds
the same victims for one scripted arrival sequence, and ``Session.submit``
(inline and process replicas) returns what the reference's ``Session`` and
brute force return.  Results are exact, so every comparison is equality.
"""
import threading
import time
import warnings
from concurrent.futures import Future

import numpy as np
import pytest

from repro_torch.common.config import CorpusConfig, LearnedIndexConfig
from repro_torch.core.learned_bloom import fit_thresholds
from repro_torch.core.membership import params_from_jax
from repro_torch.data.corpus import synthesize_corpus
from repro_torch.data.queries import brute_force_answers, sample_queries, zipf_conjunctions
from repro_torch.index.build import build_inverted_index
from repro_torch.obs.metrics import Registry
from repro_torch.rank.score import brute_force_topk
from repro_torch.serve import (
    BooleanEngine,
    QueryRequest,
    QueryResult,
    Rejected,
    ServeConfig,
    Session,
)
from repro_torch.serve.config import ObsConfig, RankedConfig, SchedConfig
from repro_torch.serve.sched import (
    MODE_RANKED,
    REJECT_DEADLINE,
    REJECT_QUEUE_FULL,
    REJECT_SHUTDOWN,
    REJECT_TENANT_QUOTA,
    REJECT_WORKER_FAILED,
    AdmissionQueue,
    Pending,
    ProcessReplica,
    ReplicaGroup,
    WorkerFailure,
)
from repro_torch.serve.sched.replica import ReplicaError

SPAWN_TIMEOUT_S = 45.0  # a replica that never answers fails its test, not the run


# ------------------------------------------------------------------ fixtures
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
    return corpus, inv, li_cfg, lb, params


def _engine(system, **cfg_kwargs):
    corpus, inv, li_cfg, lb, _ = system
    sched = dict(cfg_kwargs.pop("sched", {}))
    sched.setdefault("spawn_timeout_s", SPAWN_TIMEOUT_S)
    return BooleanEngine(lb, inv, li_cfg, ServeConfig(device="cpu", sched=sched, **cfg_kwargs))


def _queries(system):
    corpus, inv, *_ = system
    q = sample_queries(corpus, 10, max_terms=4, seed=5)
    rq = zipf_conjunctions(inv.dfs, 8, max_terms=4, seed=9)
    return q, rq


def _same_topk(got, want):
    for a, b in zip(got, want, strict=True):
        assert np.array_equal(a.ids, b.ids)
        assert np.array_equal(a.scores, b.scores)


# ------------------------------------------------------- wrapper bit-parity
def test_legacy_wrappers_bit_identical_inline(system):
    eng = _engine(system, n_shards=3)
    q, rq = _queries(system)
    want_bool = eng.query_batch(q)
    want_bm = eng.query_batch_bitmap(q)
    want_or = eng.query_topk(rq, k=10, mode="or")
    want_and = eng.query_topk(rq, k=10, mode="and")
    with Session(eng) as s:
        got_bool = s.query_batch(q)
        got_bm = s.query_batch_bitmap(q)
        got_or = s.query_topk(rq, k=10, mode="or")
        got_and = s.query_topk(rq, k=10, mode="and")
    for a, b in zip(want_bool, got_bool):
        assert np.array_equal(a, b)
    assert got_bm.dtype == np.uint32 and np.array_equal(want_bm, got_bm)
    _same_topk(got_or + got_and, want_or + want_and)


def test_submit_matches_wrapper_and_carries_timing(system):
    eng = _engine(system, n_shards=2)
    q, rq = _queries(system)
    with Session(eng) as s:
        r = s.submit(QueryRequest(terms=q[0]))
        assert isinstance(r, QueryResult) and r.ok
        assert np.array_equal(r.ids, eng.query_batch(q[:1])[0])
        assert r.scores is None and r.service_us > 0
        rr = s.submit(QueryRequest(terms=rq[0], mode=MODE_RANKED, k=5))
        want = eng.query_topk(rq[:1], k=5, mode="or")[0]
        assert np.array_equal(rr.ids, want.ids)
        assert np.array_equal(rr.scores, want.scores)


def test_legacy_wrappers_bit_identical_process_workers(system, tmp_path):
    """The acceptance edge: process replicas plan with global dfs, so the
    parallel path is bit-identical to in-process serving."""
    eng = _engine(system, n_shards=2, sched=dict(n_replicas=1))
    q, rq = _queries(system)
    want_bool = eng.query_batch(q)
    want_or = eng.query_topk(rq, k=10, mode="or")
    want_and = eng.query_topk(rq, k=10, mode="and")
    with Session(eng, store_dir=str(tmp_path)) as s:
        s.warm()
        got_bool = s.query_batch(q)
        got_or = s.query_topk(rq, k=10, mode="or")
        got_and = s.query_topk(rq, k=10, mode="and")
    for a, b in zip(want_bool, got_bool):
        assert np.array_equal(a, b)
    _same_topk(got_or + got_and, want_or + want_and)


# --------------------------------------------------------------- fake parts
class RecordingReplica:
    """Answers empty bitmaps / empty heaps; records every dispatch."""

    def __init__(self, n_docs=64):
        self.calls = []
        self.inflight = 0
        self.n_docs = n_docs

    def call(self, msg):
        self.calls.append(msg)
        if msg[0] == "bool":
            words = (self.n_docs + 31) // 32
            return np.zeros((len(msg[1]), words), dtype=np.uint32)
        if msg[0] == "topk":
            return [(np.zeros(0, np.int32), np.zeros(0, np.int64))] * len(msg[1])
        return "pong"

    def close(self):
        pass


class FlakyReplica(RecordingReplica):
    """Raises ReplicaError for the first ``fail_n`` calls, then recovers."""

    def __init__(self, fail_n, **kw):
        super().__init__(**kw)
        self.fail_n = fail_n

    def call(self, msg):
        if len(self.calls) < self.fail_n:
            self.calls.append(msg)
            raise ReplicaError("injected")
        return super().call(msg)


def _fake_session(eng, replica, **sched_kwargs):
    eng.cfg.sched = SchedConfig(**sched_kwargs)
    group = ReplicaGroup(
        0,
        [replica],
        lo=0,
        n_docs=eng.n_docs,
        retries=eng.cfg.sched.worker_retries,
        metrics=eng.metrics,
    )
    return Session(eng, replica_groups=[group], auto_start=False)


# -------------------------------------------------------- admission control
def test_saturation_sheds_lowest_priority_first(system):
    eng = _engine(system, n_shards=1)
    q, _ = _queries(system)
    s = _fake_session(eng, RecordingReplica(), max_queue=2)
    try:
        f_low_old = s.submit_async(QueryRequest(terms=q[0], priority=0, tenant="low"))
        f_low_new = s.submit_async(QueryRequest(terms=q[1], priority=0, tenant="low"))
        # queue full; a higher-priority arrival displaces the YOUNGEST
        # lowest-priority entry, preserving the FIFO head
        f_high = s.submit_async(QueryRequest(terms=q[2], priority=1, tenant="vip"))
        shed = f_low_new.result(timeout=1)
        assert isinstance(shed, Rejected) and shed.reason == REJECT_QUEUE_FULL
        assert shed.tenant == "low"
        assert not f_low_old.done() and not f_high.done()
        # next priority-1 arrival displaces the remaining priority-0 entry
        f_eq = s.submit_async(QueryRequest(terms=q[3], priority=1))
        assert f_low_old.result(timeout=1).reason == REJECT_QUEUE_FULL
        assert not f_eq.done()
        # queue is now all priority 1: an equal-priority arrival is rejected
        # itself — it may not churn the queue
        f_eq2 = s.submit_async(QueryRequest(terms=q[4], priority=1))
        eq2 = f_eq2.result(timeout=1)
        assert isinstance(eq2, Rejected) and eq2.reason == REJECT_QUEUE_FULL
        assert not f_high.done() and not f_eq.done()
        snap = eng.metrics.snapshot()["sched"]
        assert snap["shed"]["queue_full"] == 3
    finally:
        s.close()
    assert f_high.result(timeout=1).reason == REJECT_SHUTDOWN
    assert f_eq.result(timeout=1).reason == REJECT_SHUTDOWN


def test_tenant_quota_caps_queued_requests(system):
    eng = _engine(system, n_shards=1)
    q, _ = _queries(system)
    s = _fake_session(eng, RecordingReplica(), tenant_quota=1, max_queue=16)
    try:
        f1 = s.submit_async(QueryRequest(terms=q[0], tenant="chatty"))
        f2 = s.submit_async(QueryRequest(terms=q[1], tenant="chatty"))
        f3 = s.submit_async(QueryRequest(terms=q[2], tenant="other"))
        over = f2.result(timeout=1)
        assert isinstance(over, Rejected) and over.reason == REJECT_TENANT_QUOTA
        assert over.tenant == "chatty"
        assert not f1.done() and not f3.done()  # quota is per tenant
    finally:
        s.close()


def test_expired_deadline_never_reaches_a_worker(system):
    eng = _engine(system, n_shards=1)
    q, _ = _queries(system)
    replica = RecordingReplica()
    s = _fake_session(eng, replica)
    try:
        f_dead = s.submit_async(QueryRequest(terms=q[0], deadline_ms=1))
        f_live = s.submit_async(QueryRequest(terms=q[1]))
        time.sleep(0.02)  # deadline passes while the scheduler is held
        s._loop_thread.start()
        shed = f_dead.result(timeout=2)
        assert isinstance(shed, Rejected) and shed.reason == REJECT_DEADLINE
        assert f_live.result(timeout=2).ok
        # the expired request was shed at take_batch: no dispatch carried it
        assert all(len(msg[1]) == 1 for msg in replica.calls if msg[0] == "bool")
        assert eng.metrics.snapshot()["sched"]["shed"]["deadline"] == 1
    finally:
        s.close()


def test_default_deadline_from_config(system):
    eng = _engine(system, n_shards=1)
    q, _ = _queries(system)
    s = _fake_session(eng, RecordingReplica(), default_deadline_ms=1)
    try:
        f = s.submit_async(QueryRequest(terms=q[0]))
        time.sleep(0.02)
        s._loop_thread.start()
        assert f.result(timeout=2).reason == REJECT_DEADLINE
    finally:
        s.close()


# ------------------------------------------------------------- crash paths
def test_flaky_replica_retries_once_then_succeeds(system):
    eng = _engine(system, n_shards=1)
    q, _ = _queries(system)
    replica = FlakyReplica(fail_n=1)
    s = _fake_session(eng, replica)
    s._loop_thread.start()
    try:
        assert s.submit(QueryRequest(terms=q[0]), timeout=2).ok
        snap = eng.metrics.snapshot()["sched"]
        assert snap["worker_retries"] == 1
        assert snap["worker_failures"] == 0
    finally:
        s.close()


def test_dead_replica_exhausts_retries_then_typed_rejection(system):
    eng = _engine(system, n_shards=1)
    q, _ = _queries(system)
    s = _fake_session(eng, FlakyReplica(fail_n=10**6))  # never recovers
    s._loop_thread.start()
    try:
        r = s.submit(QueryRequest(terms=q[0]), timeout=2)
        assert isinstance(r, Rejected) and r.reason == REJECT_WORKER_FAILED
        assert eng.metrics.snapshot()["sched"]["worker_failures"] == 1
    finally:
        s.close()


def test_replica_group_prefers_sibling_on_retry():
    bad, good = FlakyReplica(fail_n=10**6), RecordingReplica()
    good.inflight = 5  # least-loaded picks `bad` first...
    group = ReplicaGroup(0, [bad, good], retries=1)
    assert group.call(("ping",)) == "pong"  # ...retry lands on the sibling
    assert len(bad.calls) == 1 and len(good.calls) == 1
    with pytest.raises(WorkerFailure):
        ReplicaGroup(0, [FlakyReplica(fail_n=10**6)], retries=1).call(("ping",))


def test_process_worker_crash_retry_then_typed_failure(system, tmp_path):
    """The real crash hook: ("crash",) hard-exits the worker; the group
    respawns and retries, the retry crashes again, the failure is typed."""
    eng = _engine(system, n_shards=1, sched=dict(n_replicas=1))
    with Session(eng, store_dir=str(tmp_path)) as s:
        s.warm()
        group = s._groups[0]
        with pytest.raises(WorkerFailure) as ei:
            group.call(("crash",))
        assert ei.value.attempts == 2  # retry budget spent
        # the group recovered: next dispatch respawns and serves
        assert group.call(("ping",)) == "pong"
        snap = eng.metrics.snapshot()["sched"]
        assert snap["worker_retries"] == 1 and snap["worker_failures"] == 1


# ---------------------------------------------------------- short-circuits
def test_all_pad_and_k0_short_circuit_without_dispatch(system):
    eng = _engine(system, n_shards=1)
    replica = RecordingReplica()
    s = _fake_session(eng, replica)
    try:
        pad = np.full(4, -1, np.int32)
        r = s.submit_async(QueryRequest(terms=pad)).result(timeout=1)
        assert r.ok and r.ids.size == 0 and r.scores is None
        r = s.submit_async(QueryRequest(terms=pad, mode=MODE_RANKED)).result(timeout=1)
        assert r.ok and r.ids.size == 0 and r.scores is not None and r.scores.size == 0
        r = s.submit_async(
            QueryRequest(terms=np.array([3], np.int32), mode=MODE_RANKED, k=0)
        ).result(timeout=1)
        assert r.ok and r.ids.size == 0
        assert replica.calls == []  # resolved at submit: nothing was enqueued
        snap = eng.metrics.snapshot()["sched"]
        assert snap["short_circuit"] == 3 and snap["enqueued"] == 0
    finally:
        s.close()


# -------------------------------------------------------------- coalescing
def _pending(mode="boolean", tenant="default", priority=0, deadline=None, seq=0):
    req = QueryRequest(terms=np.array([1], np.int32), mode=mode, tenant=tenant,
                       priority=priority)
    return Pending(req=req, future=Future(), row=req.terms,
                   t_submit=time.monotonic(), deadline=deadline, seq=seq)


def test_take_batch_coalesces_head_mode_across_queue():
    queue = AdmissionQueue(SchedConfig(max_batch=16, max_queue=16), Registry())
    for mode in ["boolean", "boolean", "ranked", "boolean"]:
        queue.offer(_pending(mode=mode))
    # the head's mode coalesces past the other mode (FIFO within a mode);
    # the skipped ranked entry is left at the head for the next round
    batch = queue.take_batch(16)
    assert [p.req.mode for p in batch] == ["boolean"] * 3
    assert [p.seq for p in batch] == sorted(p.seq for p in batch)
    assert [p.req.mode for p in queue.take_batch(16)] == ["ranked"]
    # max_batch still caps a same-mode pull mid-queue
    for mode in ["ranked", "boolean", "ranked", "ranked"]:
        queue.offer(_pending(mode=mode))
    assert [p.req.mode for p in queue.take_batch(2)] == ["ranked"] * 2
    # the un-pulled entries keep arrival order: boolean is now the head
    assert [p.req.mode for p in queue.take_batch(16)] == ["boolean"]
    assert [p.req.mode for p in queue.take_batch(16)] == ["ranked"]


def test_take_batch_respects_max_batch_and_arrival_order():
    queue = AdmissionQueue(SchedConfig(max_batch=16, max_queue=64), Registry())
    for _ in range(5):
        queue.offer(_pending())
    batch = queue.take_batch(3)
    assert len(batch) == 3
    assert [p.seq for p in batch] == sorted(p.seq for p in batch)  # FIFO
    assert len(queue.take_batch(16)) == 2


def test_continuous_batching_coalesces_arrivals_while_busy(system):
    """Arrivals during an in-flight dispatch pile up and go out as one batch."""
    eng = _engine(system, n_shards=1)
    q, _ = _queries(system)

    gate = threading.Event()

    class SlowReplica(RecordingReplica):
        def call(self, msg):
            if msg[0] == "bool" and not gate.is_set():
                self.calls.append(msg)
                gate.wait(timeout=5)  # hold the batch in flight
                words = (self.n_docs + 31) // 32
                return np.zeros((len(msg[1]), words), dtype=np.uint32)
            return super().call(msg)

    def _wait(cond, timeout=5.0):
        deadline = time.monotonic() + timeout
        while not cond() and time.monotonic() < deadline:
            time.sleep(0.005)
        assert cond()

    replica = SlowReplica()
    s = _fake_session(eng, replica, max_batch=16)
    s._loop_thread.start()
    try:
        # occupy every runner slot with a gated in-flight batch, one at a
        # time so they cannot coalesce with each other
        n_slots = 2 * max(1, s.sched_cfg.n_replicas)
        first = []
        for i in range(n_slots):
            first.append(s.submit_async(QueryRequest(terms=q[i])))
            _wait(lambda: len(replica.calls) == len(first))
        # all slots busy -> the loop is parked on the slot semaphore and
        # these five arrivals pile up in the admission queue
        rest = [s.submit_async(QueryRequest(terms=q[i]))
                for i in range(n_slots, n_slots + 5)]
        _wait(lambda: len(s._queue._items) == 5)
        gate.set()
        assert all(f.result(timeout=5).ok for f in first)
        assert all(f.result(timeout=5).ok for f in rest)
        sizes = [len(msg[1]) for msg in replica.calls if msg[0] == "bool"]
        # the gated slot-fillers went out alone; the five arrivals went out
        # as ONE coalesced batch (its row matrix padded up to the 8-row
        # power-of-two bucket, so count batches, not rows)
        assert sizes[:n_slots] == [1] * n_slots
        assert len(sizes) == n_slots + 1 and sizes[n_slots] == 8
        snap = eng.metrics.snapshot()["sched"]
        assert snap["batches"] == n_slots + 1
        assert snap["dispatched"] == n_slots + 5
    finally:
        s.close()


# ------------------------------------------------------------- config shim
def test_flat_kwargs_deprecated_but_land_in_subconfigs():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cfg = ServeConfig(payload_bits=4, topk_exhaustive_cutoff=0)
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert cfg.ranked.payload_bits == 4
    assert cfg.ranked.topk_exhaustive_cutoff == 0
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cfg = ServeConfig(ranked=False)  # old boolean flag
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert cfg.ranked.enabled is False and not cfg.ranked
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ServeConfig(shard_workers=4)  # retired knob: warned, ignored
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    with pytest.raises(TypeError):
        ServeConfig(not_a_knob=1)


def test_flat_kwarg_warning_cached_per_call_site():
    """A hot loop re-building configs warns once per call site, not per call."""
    from repro_torch.serve import config as cfg_mod

    cfg_mod._WARNED_SITES.clear()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(3):
            ServeConfig(payload_bits=4)  # one site: exactly one warning
    dep = [x for x in w if issubclass(x.category, DeprecationWarning)]
    assert len(dep) == 1
    # a different call site with the same kwarg still gets its own warning
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ServeConfig(payload_bits=4)
    assert sum(issubclass(x.category, DeprecationWarning) for x in w) == 1


def test_flat_attributes_forward_to_subconfigs():
    cfg = ServeConfig()
    cfg.trace = sentinel = object()
    assert cfg.obs.trace is sentinel and cfg.trace is sentinel
    cfg.payload_bits = 4
    assert cfg.ranked.payload_bits == 4
    cfg.ranked.score_kernel = True
    assert cfg.score_kernel is True
    assert isinstance(cfg.obs, ObsConfig) and isinstance(cfg.ranked, RankedConfig)


def test_subconfigs_accept_dicts():
    cfg = ServeConfig(
        obs=dict(trace=None),
        ranked=dict(payload_bits=4),
        sched=dict(n_replicas=2, max_batch=8),
    )
    assert cfg.ranked.payload_bits == 4
    assert cfg.sched.n_replicas == 2 and cfg.sched.max_batch == 8


def test_worker_spec_round_trips_engine_flags():
    cfg = ServeConfig(
        n_shards=4,
        verified=False,
        device="cpu",
        ranked=dict(payload_bits=4),
        sched=dict(n_replicas=3),
        obs=dict(trace=object()),  # handles must NOT cross the pipe
    )
    spec = cfg.worker_spec()
    clone = ServeConfig(**spec)
    assert clone.verified is False and clone.n_shards == 4
    assert clone.ranked.payload_bits == 4
    assert clone.obs.trace is None  # worker builds its own obs
    assert clone.sched.n_replicas == 0  # workers execute; the session schedules
    # the device travels: a worker built for the CPU must not default to cuda
    assert clone.device == "cpu" and ServeConfig().device == "cuda"


def test_coalesce_window_lingers_for_stragglers():
    """coalesce_us holds a non-full batch open so near-simultaneous arrivals
    ride the same dispatch."""
    queue = AdmissionQueue(
        SchedConfig(max_batch=8, max_queue=16, coalesce_us=200_000), Registry()
    )
    queue.offer(_pending())

    def late():
        time.sleep(0.03)
        queue.offer(_pending())
        queue.offer(_pending())

    t = threading.Thread(target=late)
    t.start()
    t0 = time.monotonic()
    batch = queue.take_batch(8)
    t.join()
    assert len(batch) == 3  # the stragglers made it into the lingering batch
    assert time.monotonic() - t0 < 1.0


def test_coalesce_window_anchored_to_head_submit_time():
    """The window is measured from the head's submit, not from take_batch:
    a batch that already aged while runners were busy dispatches at once."""
    queue = AdmissionQueue(
        SchedConfig(max_batch=8, max_queue=16, coalesce_us=150_000), Registry()
    )
    p = _pending()
    p.t_submit = time.monotonic() - 1.0  # aged in queue during a busy spell
    queue.offer(p)
    t0 = time.monotonic()
    assert len(queue.take_batch(8)) == 1
    assert time.monotonic() - t0 < 0.05  # no linger added on top of the age


# ------------------------------------------------------- ranked floor fan-in
def test_ranked_floor_forwarding_bit_identical(system):
    """forward_floor shares the running global kth score across the shard
    fan-in; it must only skip work, never change results."""
    _, rq = _queries(system)
    eng_f = _engine(system, n_shards=3, sched=dict(forward_floor=True))
    eng_0 = _engine(system, n_shards=3, sched=dict(forward_floor=False))
    want = eng_0.query_topk(rq, k=3, mode="or")  # engine facade reference
    with Session(eng_f) as sf, Session(eng_0) as s0:
        floors_sent = []
        for g in sf._groups:
            def wrap(msg, _orig=g.call):
                if msg[0] == "topk":
                    floors_sent.append([it[3] for it in msg[1]])
                return _orig(msg)
            g.call = wrap
        got_f = sf.query_topk(rq, k=3)
        got_0 = s0.query_topk(rq, k=3)
    _same_topk(got_f, got_0)
    _same_topk(got_f, want)
    # later groups in the sequential fan-in actually saw a raised floor
    assert any(f > 0 for fl in floors_sent for f in fl)


# ------------------------------------------------------------- warm snapshot
def test_warm_snapshot_respawn_bit_identical_and_needs_no_new_shape(system, tmp_path):
    """A crashed worker's replacement replays the recorded warm log: the
    same dense-pass shapes, the same arena upload count, the same bits.
    (The reference also checks its XLA compile-cache directory; the port
    has no compile cache, so there is none to check.)"""
    eng = _engine(
        system,
        n_shards=1,
        ranked=dict(fused_kernel=True),
        sched=dict(n_replicas=1),
    )
    _, rq = _queries(system)
    with Session(eng, store_dir=str(tmp_path)) as s:
        s.warm()
        want = s.query_topk(rq, k=5)
        rep = s._groups[0].replicas[0]
        before = rep.call(("caches",))
        assert before["dense_cache"] > 0 and before["dense_shapes"]
        assert before["arena"]["uploads"] == 1
        with pytest.raises(ReplicaError):
            rep.call(("crash",))
        after = rep.call(("caches",))  # respawn + warm-log replay first
        assert rep.warm_replays > 0 and rep.clock_syncs == 2
        assert after["dense_cache"] == before["dense_cache"]
        assert after["dense_shapes"] == before["dense_shapes"]
        assert after["arena"]["uploads"] == 1
        got = s.query_topk(rq, k=5)
        post = rep.call(("caches",))
        # serving the same shapes ran no new one
        assert post["dense_cache"] == after["dense_cache"]
        assert post["dense_shapes"] == after["dense_shapes"]
        _same_topk(got, want)
    assert (tmp_path / "warm_snapshot.json").exists()
    # a brand-new session over the same store preloads the snapshot, so its
    # first spawn replays the previous run's whole shape coverage
    eng2 = _engine(
        system,
        n_shards=1,
        ranked=dict(fused_kernel=True),
        sched=dict(n_replicas=1),
    )
    with Session(eng2, store_dir=str(tmp_path)) as s2:
        rep2 = s2._groups[0].replicas[0]
        assert len(rep2._warm_log) > 0  # seeded before the first spawn
        rep2.call(("ping",))
        assert rep2.warm_replays > 0
        _same_topk(s2.query_topk(rq, k=5), want)


# ---------------------------------------------------------------- parity
def _ref_pending(mod, mode, tenant, priority):
    req = mod.QueryRequest(terms=np.array([1], np.int32), mode=mode, tenant=tenant,
                           priority=priority)
    return mod.Pending(req=req, future=Future(), row=req.terms, t_submit=0.0, deadline=None)


def test_admission_sheds_the_same_victims_as_reference():
    """One scripted arrival sequence (priorities, tenants, a quota, a full
    queue, takes in between) through both packages' AdmissionQueue: the
    same requests are shed for the same reasons, the same batches leave,
    and the shed counters agree."""
    from repro.obs.metrics import Registry as RefRegistry
    from repro.serve import sched as ref_sched
    from repro.serve.config import SchedConfig as RefSchedConfig
    from repro_torch.serve import sched as port_sched

    rng = np.random.default_rng(5)
    script = []
    for i in range(60):
        if i % 9 == 8:
            script.append(("take", int(rng.integers(1, 5))))
        else:
            mode = "ranked" if rng.random() < 0.3 else "boolean"
            script.append(("offer", mode, f"t{int(rng.integers(0, 3))}",
                           int(rng.integers(0, 3))))
    outcomes = {}
    for name, mod, cfg_cls, reg_cls in (("port", port_sched, SchedConfig, Registry),
                                         ("ref", ref_sched, RefSchedConfig, RefRegistry)):
        reg = reg_cls()
        queue = mod.AdmissionQueue(cfg_cls(max_queue=6, tenant_quota=3), reg, clock=lambda: 0.0)
        pend, log = [], []
        for step in script:
            if step[0] == "offer":
                p = _ref_pending(mod, *step[1:])
                pend.append(p)
                log.append(("admit", queue.offer(p)))
            else:
                log.append(("batch", [pend.index(p) for p in queue.take_batch(step[1])]))
        shed = [(i, p.future.result().reason) for i, p in enumerate(pend) if p.future.done()]
        outcomes[name] = (log, shed, reg.snapshot()["sched"])
    assert outcomes["port"] == outcomes["ref"]
    assert any(r == REJECT_QUEUE_FULL for _, r in outcomes["port"][1])
    assert any(r == REJECT_TENANT_QUOTA for _, r in outcomes["port"][1])


@pytest.fixture(scope="module")
def reference_answers(system):
    """The reference's Session (inline) over the same collection, parameters
    and thresholds: Boolean results and top-10 lists of the test batch."""
    import jax.numpy as jnp

    from repro.common.config import LearnedIndexConfig as RefLIConfig
    from repro.core.learned_bloom import LearnedBloom as RefLearnedBloom
    from repro.serve import BooleanEngine as RefEngine
    from repro.serve import QueryRequest as RefRequest
    from repro.serve import ServeConfig as RefServeConfig
    from repro.serve import Session as RefSession

    corpus, inv, li_cfg, lb, params = system
    ref_params = {"term_embed": {"table": jnp.asarray(params["term_embed"]["table"])},
                  "doc_embed": {"table": jnp.asarray(params["doc_embed"]["table"])},
                  "bias": jnp.asarray(params["bias"])}
    ref_lb = RefLearnedBloom(params=ref_params, tau=lb.tau.numpy(),
                             backup_keys=np.zeros(0, np.int64), n_docs=inv.n_docs)
    ref = RefEngine(ref_lb, inv, RefLIConfig(embed_dim=16, truncation_k=16, block_size=64),
                    RefServeConfig(n_shards=2))
    q, rq = _queries(system)
    with RefSession(ref) as s:
        bool_ids = [s.submit(RefRequest(terms=row)).ids for row in q]
        ranked = [s.submit(RefRequest(terms=row, mode="ranked", k=10)) for row in rq]
    return bool_ids, [(r.ids, r.scores) for r in ranked]


@pytest.mark.parametrize("replicas", [0, 1], ids=["inline", "process"])
def test_session_submit_matches_reference_session_and_brute_force(
        system, reference_answers, tmp_path, replicas):
    corpus, inv, *_ = system
    q, rq = _queries(system)
    want_bool, want_ranked = reference_answers
    eng = _engine(system, n_shards=2, sched=dict(n_replicas=replicas))
    with Session(eng, store_dir=str(tmp_path) if replicas else None) as s:
        futs = [s.submit_async(QueryRequest(terms=row)) for row in q]
        rfuts = [s.submit_async(QueryRequest(terms=row, mode=MODE_RANKED, k=10)) for row in rq]
        got_bool = [f.result(timeout=60) for f in futs]
        got_ranked = [f.result(timeout=60) for f in rfuts]
    exact = brute_force_answers(corpus, q)
    for g, w, e in zip(got_bool, want_bool, exact, strict=True):
        assert g.ok and np.array_equal(g.ids, w) and np.array_equal(g.ids, e)
    oracle = brute_force_topk(inv, eng.impact_model, rq, 10)
    for g, (wi, ws), o in zip(got_ranked, want_ranked, oracle, strict=True):
        assert g.ok and np.array_equal(g.ids, wi) and np.array_equal(g.scores, ws)
        assert np.array_equal(g.ids, o.ids) and np.array_equal(g.scores, o.scores)


def test_worker_that_cannot_serve_yields_typed_failure_not_a_cpu_answer(system, tmp_path):
    """No fallback: a worker spec that asks for the card where there is none
    fails its build; the session retries once, then rejects the batch as
    ``worker_failed`` — nothing is answered on the CPU instead."""
    import torch

    eng = _engine(system, n_shards=1, sched=dict(n_replicas=1, warm_snapshot=False))
    q, _ = _queries(system)
    # what the workers are told: the card where there is none (a device the
    # port does not serve on, where there is one)
    eng.cfg.device = "meta" if torch.cuda.is_available() else "cuda"
    with Session(eng, store_dir=str(tmp_path)) as s:
        r = s.submit(QueryRequest(terms=q[0]), timeout=60)
        assert isinstance(r, Rejected) and r.reason == REJECT_WORKER_FAILED
        assert "CUDA is not available" in r.detail or "unsupported device" in r.detail
        assert isinstance(s._groups[0].replicas[0], ProcessReplica)
    snap = eng.metrics.snapshot()["sched"]
    assert snap["worker_retries"] == 1 and snap["worker_failures"] == 1


def test_dense_warm_shape_runs_one_pass_and_counts_its_shape(system):
    """``warm_shape`` runs the dense pass once at an observed shape on inert
    inputs, which ``cache_size``/``observed_shapes`` then count; a shape of
    another arena's width is left alone."""
    from repro_torch.kernels.fused_query import dense

    eng = _engine(system, n_shards=1, ranked=dict(fused_kernel=True))
    arena = eng.shards[0].ranked.arena
    assert arena is not None
    shape = (arena.n_docs, 24, 12, 7)  # off the quanta: no pass served it before
    before, passes, hits = dense.cache_size(), dense.launches, arena.counters.hits
    dense.warm_shape(arena, shape)
    assert shape in dense.observed_shapes() and dense.cache_size() == before + 1
    assert dense.launches == passes + 1 and arena.counters.hits == hits + 1
    dense.warm_shape(arena, (arena.n_docs + 1, 8, 4, 10))
    assert dense.cache_size() == before + 1 and dense.launches == passes + 1
