"""Serving launcher for the port's Boolean and ranked query engine.

Builds a synthetic collection, trains the membership model briefly, fits
zero-FN thresholds, and serves batched conjunctive queries through
``BooleanEngine.query_batch`` — learned-Bloom candidates on the device
(``--algorithm``: Algorithm 3 ``block`` by default, Algorithm 2
``two_tier`` with tier-1 lists of ``--k`` entries, or Algorithm 1
``exhaustive``), exact verification against the compressed tier-2 store —
asserting the results against brute force: every result exact, and for
``two_tier`` every query that ``two_tier_guaranteed`` covers on every
active shard exact and every other result a subset of the exact one (the
paper's §3.2 guarantee).  ``--index-dir DIR`` saves the sharded index
(index/store.py, the layout the reference reads) and serves from the
reloaded store.  Then, unless ``--topk 0``, it serves a batch of Zipf OR
queries through ``BooleanEngine.query_topk`` (multi-phase MaxScore, or
``--fused`` for the fused_topk kernel and the dense arena loop) and asserts
the ranked results equal brute-force quantized BM25.

``--replicas N`` also serves the Boolean batch through the scheduler
(``Session.submit``: 0 = inline, N > 0 = N spawned process replicas per
shard, each rebuilt from the shard-store and serving on ``--device``) and
asserts its results equal the facade's; ``--deadline-ms`` sets the
scheduler's default deadline, ``--slo`` prints its rolling SLO report, a
latency autopsy and Prometheus text.  ``--trace-out`` writes a Chrome trace
of every served batch (worker spans in their own lanes), ``--probe-log``
streams one JSONL record per routed probe (``--probe-log-max-bytes``
rotates it).

  PYTHONPATH=src python -m repro_torch.launch.serve --queries 64
  PYTHONPATH=src python -m repro_torch.launch.serve --shards 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --topk 10 --fused
  PYTHONPATH=src python -m repro_torch.launch.serve --algorithm two_tier --shards 4
  PYTHONPATH=src python -m repro_torch.launch.serve --shards 4 --index-dir /tmp/idx
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --replicas 1 \
      --index-dir /tmp/idx --trace-out /tmp/t.json --slo
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common.config import CorpusConfig, LearnedIndexConfig, OptimizerConfig
from repro_torch.common.device import resolve_device
from repro_torch.core import MembershipModel, fit_thresholds, membership_loss, two_tier_guaranteed
from repro_torch.core.learned_bloom import false_negative_rate
from repro_torch.data.corpus import Corpus, synthesize_corpus
from repro_torch.data.loader import membership_batches
from repro_torch.data.queries import brute_force_answers, sample_queries, zipf_disjunctions
from repro_torch.index.build import InvertedIndex, build_inverted_index
from repro_torch.obs import ProbeLog, Tracer, render_prometheus
from repro_torch.rank.score import ImpactModel, brute_force_topk
from repro_torch.serve import BooleanEngine, QueryRequest, RankedConfig, ServeConfig, Session
from repro_torch.train import init_train_state, make_train_step


def train_membership(
    corpus: Corpus,
    inv: InvertedIndex,
    li_cfg: LearnedIndexConfig,
    *,
    steps: int = 300,
    lr: float = 0.05,
    batch_size: int = 2048,
    seed: int = 0,
    device: str | torch.device = "cuda",
    log=print,
) -> MembershipModel:
    """The reference launcher's training loop: BCE over sampled (term, doc)
    pairs of the replaced (df > truncation_k) terms, AdamW."""
    dev = resolve_device(device)
    model = MembershipModel.init(li_cfg, corpus.n_terms, corpus.n_docs, seed=seed, device=dev)
    replaced = np.nonzero(inv.dfs > li_cfg.truncation_k)[0]
    it = membership_batches(
        corpus, batch_size=batch_size,
        negatives_per_positive=li_cfg.train_negatives_per_positive,
        replaced_terms=replaced if len(replaced) else None,
    )
    ocfg = OptimizerConfig(lr=lr, warmup_steps=20, total_steps=steps, weight_decay=0.0)
    step = make_train_step(membership_loss, ocfg)
    st = init_train_state(model, ocfg)
    for i, batch in zip(range(steps), it):
        m = step(model, st, {
            "terms": torch.from_numpy(batch["terms"].astype(np.int64)).to(dev),
            "docs": torch.from_numpy(batch["docs"].astype(np.int64)).to(dev),
            "labels": torch.from_numpy(batch["labels"]).to(dev),
        })
        if i % 100 == 0:
            log(f"[serve] membership train step {i} loss {float(m['loss']):.4f}")
    return model


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--algorithm", default="block", choices=["exhaustive", "two_tier", "block"])
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--terms", type=int, default=8000)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--train-steps", type=int, default=300)
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--use-kernel", action="store_true",
                    help="accepted for parity with the reference launcher: on cuda "
                         "the kernels always run, on cpu their plain versions")
    ap.add_argument("--shards", type=int, default=1,
                    help="document partitions served by the planner/executor")
    ap.add_argument("--index-dir", default=None,
                    help="persist the sharded index here, then serve from the "
                         "reloaded store (build-then-serve round trip)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain PyTorch versions)")
    ap.add_argument("--topk", type=int, default=10,
                    help="also serve a ranked top-K disjunctive batch "
                         "(0 disables the ranked path)")
    ap.add_argument("--fused", action="store_true",
                    help="answer each shard's ranked batch with fused_topk "
                         "launches (and the dense arena loop where a shard "
                         "fits one) instead of the multi-phase pipeline; "
                         "disables the small-query exhaustive shortcut so "
                         "the kernel runs on demo-sized collections")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace JSON of every served batch here")
    ap.add_argument("--probe-log", default=None,
                    help="stream per-(query, term, shard) probe records (JSONL)")
    ap.add_argument("--probe-log-max-bytes", type=int, default=None,
                    help="rotate the probe log past this size (<path>.1 keeps "
                         "the previous window; unset = unbounded)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="also serve through the scheduler (Session.submit): "
                         "0 = inline, N>0 = N process replicas per shard")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="scheduler default deadline; requests queued past it "
                         "are shed with a typed Rejected")
    ap.add_argument("--slo", action="store_true",
                    help="print the scheduler's rolling SLO report, a per-request "
                         "latency autopsy and Prometheus-rendered metrics "
                         "(implies --replicas 0 when --replicas is unset)")
    args = ap.parse_args(argv)
    if args.slo and args.replicas is None:
        args.replicas = 0  # the SLO report reads the scheduler's window
    dev = resolve_device(args.device)

    corpus = synthesize_corpus(CorpusConfig(n_docs=args.docs, n_terms=args.terms, avg_doc_len=80))
    inv = build_inverted_index(corpus)
    li_cfg = LearnedIndexConfig(embed_dim=64, truncation_k=args.k, block_size=args.block_size)
    model = train_membership(corpus, inv, li_cfg, steps=args.train_steps, device=dev)
    lb = fit_thresholds(model, inv)
    print(f"[serve] false-negative rate {false_negative_rate(lb, inv)}")
    tracer = Tracer() if args.trace_out else None
    probe_log = (ProbeLog(args.probe_log, max_bytes=args.probe_log_max_bytes)
                 if args.probe_log else None)
    cfg = ServeConfig(algorithm=args.algorithm, verified=not args.no_verify,
                      use_kernel=args.use_kernel, n_shards=args.shards, device=str(dev),
                      obs=dict(trace=tracer, probe_log=probe_log,
                               probe_log_max_bytes=args.probe_log_max_bytes),
                      ranked=dict(fused_kernel=args.fused,
                                  # the exhaustive shortcut would swallow every
                                  # demo-sized query before the fused launch
                                  topk_exhaustive_cutoff=0 if args.fused
                                  else RankedConfig.topk_exhaustive_cutoff))
    eng = BooleanEngine(lb, inv, li_cfg, cfg)
    if args.index_dir:
        t0 = time.time()
        eng.save(args.index_dir)
        save_s = time.time() - t0
        t0 = time.time()
        eng = BooleanEngine.from_store(lb, li_cfg, cfg, args.index_dir)
        print(f"[serve] index saved to {args.index_dir} in {save_s:.2f}s, "
              f"reloaded in {time.time() - t0:.2f}s — serving from the store")
    print(f"[serve] {len(eng.shards)} active shard(s), ranges {eng._ranges}, device {dev}")

    q = sample_queries(corpus, args.queries, seed=3)
    t0 = time.time()
    results = eng.query_batch(q)
    dt = (time.time() - t0) / args.queries * 1e3
    exact = brute_force_answers(corpus, q)
    n_exact = sum(np.array_equal(r, e) for r, e in zip(results, exact))
    n_super = sum(np.setdiff1d(e, r).size == 0 for r, e in zip(results, exact))
    print(f"[serve] {args.queries} queries, {dt:.2f} ms/query (first batch, tier-2 build "
          f"included), exact={n_exact}/{args.queries}, superset={n_super}/{args.queries}")
    print("[serve] memory report (bits):", eng.memory_report())
    if not args.no_verify:
        if args.algorithm == "two_tier":
            check_two_tier(eng, q, results, exact, li_cfg.truncation_k)
        elif n_exact != args.queries:
            raise SystemExit("verified mode must be exact")
        else:
            print("[serve] verified mode: all results exact")
    s = eng.metrics.snapshot()["summary"]
    print(f"[serve] summary: {s['n_shards']} shards, cache "
          f"{s['cache_hits']}h/{s['cache_misses']}m/{s['cache_evictions']}e, "
          f"probe bytes {s['probe_bytes']} (ratio {s['bytes_ratio']:.3f})")

    if args.topk > 0:
        ranked_q, _ = zipf_disjunctions(inv.dfs, args.queries, seed=7)
        t0 = time.time()
        ranked = eng.query_topk(ranked_q, args.topk)
        dt = (time.time() - t0) / args.queries * 1e3
        im = eng.impact_model or ImpactModel.build(inv)  # a loaded store fits none
        oracle = brute_force_topk(inv, im, ranked_q, args.topk)
        ok = all(
            np.array_equal(r.ids, e.ids) and np.array_equal(r.scores, e.scores)
            for r, e in zip(ranked, oracle)
        )
        rs = eng.metrics.snapshot()["ranked"]
        print(f"[serve] ranked top-{args.topk}: {args.queries} OR queries, "
              f"{dt:.2f} ms/query (payload attach included), "
              f"exact-vs-BM25-brute-force={ok}, scored {rs['touched_postings']}/"
              f"{rs['exhaustive_postings']} postings (fraction {rs['scored_fraction']:.3f})")
        print("[serve] ranked stats:", rs)
        if not ok:
            raise SystemExit("ranked serving must match brute-force BM25")

    if args.replicas is not None:
        serve_scheduled(eng, q, results, args, tracer)
    lat = eng.metrics.snapshot().get("latency", {})
    for name in ("query_us", "topk_query_us"):
        h = lat.get(name)
        if h:
            print(f"[serve] latency {name}: p50 {h['p50'] / 1e3:.2f} ms, "
                  f"p99 {h['p99'] / 1e3:.2f} ms over {h['count']} queries")
    if probe_log is not None:
        probe_log.close()
        print(f"[serve] probe log written to {args.probe_log}")
    if tracer is not None:
        tracer.save(args.trace_out)
        print(f"[serve] trace written to {args.trace_out} ({len(tracer.spans)} spans)")


def serve_scheduled(eng: BooleanEngine, q: np.ndarray, results, args, tracer) -> None:
    """Serve ``q`` again through ``Session.submit`` (``--replicas``) and
    raise unless every served result equals the facade's."""
    import tempfile

    eng.cfg.sched.n_replicas = args.replicas
    eng.cfg.sched.default_deadline_ms = args.deadline_ms
    store = args.index_dir or (
        tempfile.mkdtemp(prefix="repro-shards-") if args.replicas > 0 else None)
    with Session(eng, store_dir=store) as session:
        if args.replicas > 0:
            session.warm()  # spawn and first launches outside the timed region
        t0 = time.time()
        futs = [session.submit_async(QueryRequest(terms=row), block=True) for row in q]
        outs = [f.result() for f in futs]
        dt = (time.time() - t0) / len(q) * 1e3
        served = [o for o in outs if o.ok]
        shed = [o for o in outs if not o.ok]
        n_same = sum(np.array_equal(o.ids, r) for o, r in zip(outs, results) if o.ok)
        sm = eng.metrics.snapshot()["sched"]
        kind = f"{args.replicas} process replica(s)/shard" if args.replicas else "inline"
        print(f"[serve] scheduler ({kind}): {len(served)} served in {sm['batches']} batches "
              f"(mean size {sm['batch_size']['mean']:.1f}), {dt:.2f} ms/query, "
              f"parity-with-facade={n_same}/{len(served)}")
        if shed:
            print(f"[serve] scheduler shed {len(shed)} request(s): "
                  f"{sorted({o.reason for o in shed})}")
        if n_same != len(served):
            raise SystemExit("Session.submit must match query_batch")
        if served:
            a = served[0].autopsy()
            print(f"[serve] autopsy (first served): total {a['total_us'] / 1e3:.2f} ms = "
                  f"queue {a['queue_us'] / 1e3:.2f} + dispatch {a['dispatch_us'] / 1e3:.2f} + "
                  f"execute {a['execute_us'] / 1e3:.2f} + merge {a['merge_us'] / 1e3:.2f} ms "
                  f"(execute {a['execute_frac']:.0%} of total)")
        if tracer is not None and args.replicas > 0:
            lanes = sorted({s.pid for s in tracer.spans if s.pid != 0})
            wspans = sum(1 for s in tracer.spans if s.pid != 0)
            print(f"[serve] distributed trace: {wspans} worker spans across "
                  f"{len(lanes)} replica lane(s) collated onto the host timeline")
        if args.slo:
            rep = session.slo_report()
            print(f"[serve] SLO report (window {rep['window_s']:.0f}s, "
                  f"target {rep['target']:.0%}):")
            for tenant, t in sorted(rep["tenants"].items()):
                print(f"[serve]   tenant {tenant!r}: {t['requests']} req ({t['shed']} shed), "
                      f"hit-rate {t['deadline_hit_rate']:.1%}, p99 {t['p99_ms']:.2f} ms, "
                      f"burn {t['burn_rate']:.2f}x")
            prom = render_prometheus({"sched": rep["sched"]})
            print(f"[serve] prometheus ({len(prom.splitlines())} lines):")
            for line in prom.splitlines()[:6]:
                print(f"[serve]   {line}")


def check_two_tier(eng: BooleanEngine, q: np.ndarray, results, exact, k: int) -> np.ndarray:
    """The paper's §3.2 guarantee for verified two-tier results: a query
    whose tier-1 lists cover it on every active shard (each shard truncates
    its own local lists) is exact, every other result a subset of the
    exact one.  Raises otherwise -> the (Q,) guaranteed mask."""
    guar = np.ones(len(q), bool)
    for sh in eng.shards:
        guar &= two_tier_guaranteed(sh.state.dfs, q, k, with_model=True)
    for i, (r, e) in enumerate(zip(results, exact)):
        if guar[i] and not np.array_equal(r, e):
            raise SystemExit(f"two_tier: guaranteed query {i} is not exact")
        if not np.isin(r, e).all():
            raise SystemExit(f"two_tier: query {i} returned a doc outside the exact answer")
    print(f"[serve] two_tier: {int(guar.sum())}/{len(q)} queries guaranteed on every shard "
          f"and exact, every result a subset of the exact one")
    return guar


if __name__ == "__main__":
    main()
