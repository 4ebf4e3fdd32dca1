"""Quickstart: build a collection, train the learned membership index, serve
exact Boolean and ranked queries — the paper's full pipeline on the port,
the 13 steps of the reference's ``examples/quickstart.py`` with its checks.

  PYTHONPATH=src python -m repro_torch.launch.quickstart            # on the card
  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu --small

``--device cpu`` runs every kernel's plain PyTorch version; ``--small``
shrinks the collection and the training for a quick check.  Any failed check
raises, and the process exits non-zero.  ``run`` returns the numbers it
prints.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.common.config import CorpusConfig, LearnedIndexConfig, OptimizerConfig
from repro_torch.common.device import resolve_device
from repro_torch.core import estimate_gain, fit_thresholds, init_membership, membership_loss
from repro_torch.data.corpus import synthesize_corpus
from repro_torch.data.loader import membership_batches
from repro_torch.data.queries import (
    brute_force_answers,
    sample_queries,
    zipf_conjunctions,
    zipf_disjunctions,
)
from repro_torch.index.build import build_inverted_index
from repro_torch.obs import ProbeLog, Tracer, nesting_violations, render_prometheus
from repro_torch.rank.score import brute_force_topk, dequantize_scores
from repro_torch.serve import BooleanEngine, QueryRequest, ServeConfig, Session
from repro_torch.train import init_train_state, make_train_step

# the reference's sizes, and the --small ones
FULL = dict(corpus=dict(n_docs=1500, n_terms=6000, avg_doc_len=70), steps=200)
SMALL = dict(corpus=dict(n_docs=600, n_terms=2400, avg_doc_len=40), steps=40)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _same(results, expected) -> bool:
    return all(np.array_equal(r, e) for r, e in zip(results, expected, strict=True))


def run(device: str = "cuda", small: bool = False, log=print) -> dict:
    dev = resolve_device(device)
    size = SMALL if small else FULL
    out: dict = {"device": str(dev), "small": small}

    # 1. a Robust-like collection (synthetic, df-calibrated)
    corpus = synthesize_corpus(CorpusConfig(**size["corpus"]))
    inv = build_inverted_index(corpus)
    log(f"collection: {corpus.n_docs} docs, {corpus.n_postings} postings")

    # 2. the paper's Eq.(2): how much storage could the learned index save?
    g = estimate_gain(inv, k=48)
    log(f"Eq.(2) @ k=48: upper {g.gain_upper_frac:.1%}, "
        f"lower (s=512b) {g.gain_lower_frac:.1%}, |R|={g.n_replaced}")
    out["gain"] = {"upper": g.gain_upper_frac, "lower": g.gain_lower_frac,
                   "replaced": g.n_replaced}

    # 3. train f(t,d) — the learned index model
    li_cfg = LearnedIndexConfig(embed_dim=64, truncation_k=48, block_size=128)
    model = init_membership(li_cfg, corpus.n_terms, corpus.n_docs, seed=0, device=dev)
    steps = size["steps"]
    ocfg = OptimizerConfig(lr=0.05, warmup_steps=10, total_steps=steps, weight_decay=0.0)
    step = make_train_step(membership_loss, ocfg)
    state = init_train_state(model, ocfg)
    for _, batch in zip(range(steps), membership_batches(corpus, batch_size=2048)):
        m = step(model, state, {
            "terms": torch.from_numpy(batch["terms"].astype(np.int64)).to(dev),
            "docs": torch.from_numpy(batch["docs"].astype(np.int64)).to(dev),
            "labels": torch.from_numpy(batch["labels"]).to(dev),
        })
    out["loss"] = float(m["loss"])
    log(f"membership model trained, final loss {out['loss']:.4f}")

    # 4. learned-Bloom construction: zero false negatives by construction
    lb = fit_thresholds(model, inv)

    # 5. serve conjunctive Boolean queries (Algorithm 3 + exact verification)
    eng = BooleanEngine(lb, inv, li_cfg, ServeConfig(algorithm="block", verified=True,
                                                     device=str(dev)))
    queries = sample_queries(corpus, 16, seed=1)
    results = eng.query_batch(queries)
    ok = _same(results, brute_force_answers(corpus, queries))
    log(f"16 queries served, exact={ok}")
    log(f"memory report (bits): {eng.memory_report()}")

    # 6. the §3.3 hybrid tier-2 store: per-term min-bits codec (learned or
    # classical), decoded exactly during verification above
    bpp = eng.tier2.size_bits() / inv.n_postings
    log(f"tier-2 hybrid store: {bpp:.2f} bits/posting (raw 32.00), "
        f"codec split {eng.tier2.codec_histogram()}")
    _require(ok, "step 5: Boolean results differ from brute force")

    # 7. model-guided conjunctive serving: a batched 2-5-term AND workload
    # verified by ε-window probes on the learned streams
    conj = zipf_conjunctions(inv.dfs, 8, seed=3)
    conj_results = eng.query_batch(conj)
    conj_exact = brute_force_answers(corpus, conj)
    _require(_same(conj_results, conj_exact), "step 7: guided results differ from brute force")
    report = eng.memory_report()
    log(f"guided conjunctive batch: {len(conj)} queries, "
        f"{sum(len(r) for r in conj_results)} result docs")
    log(f"memory report (bits): {report}")
    _require("tier2_bits" in report, "step 7: memory report lacks tier2_bits")
    guided = eng.metrics.snapshot()["guided"]
    log(f"guided probes: {guided['probes']}, bytes touched {guided['guided_bytes']} vs "
        f"full-decode {guided['full_equiv_bytes']} (ratio {guided['bytes_ratio']:.3f})")
    out["guided_probes"] = guided["probes"]

    # 8. restartable, doc-partitioned serving: persist the sharded index,
    # reload it mmap-lazily, and serve identical results from 4 shards
    sharded_cfg = ServeConfig(algorithm="block", verified=True, n_shards=4, device=str(dev))
    sharded = BooleanEngine(lb, inv, li_cfg, sharded_cfg)
    with tempfile.TemporaryDirectory() as index_dir:
        sharded.save(index_dir)
        restarted = BooleanEngine.from_store(lb, li_cfg, sharded_cfg, index_dir)
        reload_results = restarted.query_batch(conj)
    _require(_same(reload_results, conj_exact), "step 8: reloaded store differs")
    summary = restarted.metrics.snapshot()["summary"]
    log(f"sharded round trip: {summary['n_shards']} shards served {len(conj)} queries from "
        f"the reloaded store, cache {summary['cache_hits']}h/{summary['cache_misses']}m, "
        f"probe bytes {summary['probe_bytes']}")

    # 9. ranked retrieval: a top-10 BM25 disjunction over the tf payload
    # streams, checked against brute-force BM25 (bit-identical)
    ranked_q, _ = zipf_disjunctions(inv.dfs, 1, min_terms=4, max_terms=5, seed=9)
    (top,) = eng.query_topk(ranked_q, 10)
    (oracle,) = brute_force_topk(inv, eng.impact_model, ranked_q, 10)
    _require(np.array_equal(top.ids, oracle.ids) and np.array_equal(top.scores, oracle.scores),
             "step 9: ranked top-10 differs from brute-force BM25")
    terms = [int(t) for t in ranked_q[0] if t >= 0]
    log(f"top-10 BM25 for OR query {terms} (scores vs brute force: equal):")
    for doc, q_score, f_score in zip(top.ids, top.scores,
                                     dequantize_scores(top.scores, eng.impact_model)):
        log(f"  doc {int(doc):5d}  impact {int(q_score):4d}  bm25≈{f_score:.3f}")
    rs = eng.metrics.snapshot()["ranked"]
    log(f"ranked path scored {rs['touched_postings']} of {rs['exhaustive_postings']} postings "
        f"(fraction {rs['scored_fraction']:.3f})")

    # 10. observability: the same workloads with the span tracer and probe
    # log on; per-phase latency percentiles from the metrics registry
    tracer, plog = Tracer(), ProbeLog()
    obs_eng = BooleanEngine(lb, inv, li_cfg, ServeConfig(
        algorithm="block", verified=True, device=str(dev), obs=dict(trace=tracer, probe_log=plog)))
    obs_eng.query_batch(conj)
    obs_eng.query_topk(ranked_q, 10)
    lat = obs_eng.metrics.snapshot()["latency"]
    for name in ("query_us", "topk_query_us"):
        h = lat[name]
        log(f"latency {name}: p50 {h['p50'] / 1e3:.2f} ms, p99 {h['p99'] / 1e3:.2f} ms over "
            f"{h['count']} queries")
    routes = sorted({r.route for r in plog.records})
    log(f"traced {len(tracer.spans)} spans across {len({s.name for s in tracer.spans})} "
        f"phases; {plog.n_records} probe records, routes {routes}")
    with tempfile.TemporaryDirectory() as d:
        tracer.save(f"{d}/quickstart.trace.json")
        log(f"Chrome trace saved (open in ui.perfetto.dev): "
            f"{len(tracer.chrome_trace()['traceEvents'])} events")
    out["spans"] = len(tracer.spans)

    # 11. the serving front-end: one request type through the Session,
    # inline replicas; an already-expired deadline comes back typed
    with Session(sharded) as session:
        r = session.submit(QueryRequest(terms=conj[0]))
        _require(r.ok and np.array_equal(r.ids, conj_results[0]), "step 11: Boolean request")
        rr = session.submit(QueryRequest(terms=ranked_q[0], mode="ranked", k=10))
        _require(np.array_equal(rr.ids, top.ids), "step 11: ranked request")
        never = session.submit(QueryRequest(terms=conj[1], deadline_ms=0.0))
        sm = sharded.metrics.snapshot()["sched"]
    log(f"scheduler: served boolean+ranked via Session.submit (parity with steps 7/9), queue "
        f"wait {r.queue_us / 1e3:.2f} ms; an already-expired deadline came back typed: "
        f"ok={never.ok} reason={never.reason!r}; {sm['batches']} batches dispatched, "
        f"{sm['shed']['deadline']} shed")
    _require(not never.ok and never.reason == "deadline", "step 11: deadline not rejected")

    # 12. distributed tracing + SLO telemetry: the same ranked query through
    # a real process replica, its spans merged onto one timeline
    dist_tracer = Tracer()
    dist_cfg = ServeConfig(algorithm="block", verified=True, n_shards=2, device=str(dev),
                           sched=dict(n_replicas=1),
                           obs=dict(trace=dist_tracer, probe_log=ProbeLog()))
    dist_eng = BooleanEngine(lb, inv, li_cfg, dist_cfg)
    with tempfile.TemporaryDirectory() as store_dir:
        with Session(dist_eng, store_dir=store_dir) as session:
            session.warm()  # spawn the replicas outside the request
            rr = session.submit(QueryRequest(terms=ranked_q[0], mode="ranked", k=10),
                                timeout=120)
            _require(rr.ok and np.array_equal(rr.ids, top.ids), "step 12: replica's top-10")
            a = rr.autopsy()
            slo = session.slo_report()
    lanes = sorted({s.pid for s in dist_tracer.spans})
    worker_names = {s.name for s in dist_tracer.spans if s.pid != 0}
    _require(len(lanes) > 1, "step 12: worker spans must merge into the host timeline")
    violations = nesting_violations(dist_tracer.spans, slack_us=0.5)
    _require(violations == [], f"step 12: nesting violations {violations[:3]}")
    log(f"distributed trace: {len(lanes)} pid lanes (host + {len(lanes) - 1} workers), "
        f"worker phases {sorted(worker_names)[:4]}...")
    log(f"autopsy: total {a['total_us'] / 1e3:.2f} ms = queue {a['queue_us'] / 1e3:.2f} + "
        f"dispatch {a['dispatch_us'] / 1e3:.2f} + execute {a['execute_us'] / 1e3:.2f} + merge "
        f"{a['merge_us'] / 1e3:.2f} ms ({a['execute_frac']:.0%} execute)")
    ten = slo["tenants"]["default"]
    log(f"slo window: {ten['requests']} request(s), hit rate {ten['deadline_hit_rate']:.0%}, "
        f"p99 {ten['p99_ms']:.2f} ms, burn {ten['burn_rate']:.2f}x of target "
        f"{slo['target']:.0%}")
    prom = render_prometheus({"sched": slo["sched"]})
    log("prometheus exposition (first 3 lines):")
    for line in prom.splitlines()[:3]:
        log(f"  {line}")
    out["worker_lanes"] = len(lanes) - 1

    # 13. the device-resident fused ranked path: the impact arena is
    # uploaded once per process, whatever the number of queries
    fused_eng = BooleanEngine(lb, inv, li_cfg, ServeConfig(ranked=dict(fused_kernel=True),
                                                           device=str(dev)))
    (ftop,) = fused_eng.query_topk(ranked_q, 10)
    _require(np.array_equal(ftop.ids, top.ids) and np.array_equal(ftop.scores, top.scores),
             "step 13: fused top-10 differs from step 9's")
    fused_eng.reset_stats()
    fused_eng.query_topk(ranked_q, 10)
    fs = fused_eng.metrics.snapshot()["ranked"]
    arena = fused_eng.shards[0].metrics.snapshot()["arena"]
    log(f"fused dispatch: kernel {fs['fused_kernel_ns'] / 1e6:.2f} ms vs host bridge "
        f"{fs['fused_bridge_ns'] / 1e6:.2f} ms; arena {arena['upload_bytes'] / 1e6:.1f} MB "
        f"uploaded {arena['uploads']}x, {arena['hits']} resident dispatch(es)")
    _require(arena["uploads"] == 1, "step 13: the arena was uploaded more than once")
    out["arena_uploads"] = arena["uploads"]
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain PyTorch versions)")
    ap.add_argument("--small", action="store_true",
                    help="a smaller collection and shorter training, for a quick check")
    args = ap.parse_args(argv)
    run(args.device, args.small)


if __name__ == "__main__":
    main()
