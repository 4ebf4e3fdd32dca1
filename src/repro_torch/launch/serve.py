"""Serving launcher for the port's Boolean-query engine.

Builds a synthetic collection, trains the membership model briefly, fits
zero-FN thresholds, and serves batched conjunctive queries through
``BooleanEngine.query_batch`` — Algorithm 3 candidates on the device, exact
verification against the compressed tier-2 store — asserting exactness
against brute force.

  PYTHONPATH=src python -m repro_torch.launch.serve --queries 64
  PYTHONPATH=src python -m repro_torch.launch.serve --shards 4 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common.config import CorpusConfig, LearnedIndexConfig, OptimizerConfig
from repro_torch.common.device import resolve_device
from repro_torch.core import MembershipModel, fit_thresholds, membership_loss
from repro_torch.core.learned_bloom import false_negative_rate
from repro_torch.data.corpus import Corpus, synthesize_corpus
from repro_torch.data.loader import membership_batches
from repro_torch.data.queries import brute_force_answers, sample_queries
from repro_torch.index.build import InvertedIndex, build_inverted_index
from repro_torch.serve import BooleanEngine, ServeConfig
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
    ap.add_argument("--algorithm", default="block", choices=["exhaustive", "block"])
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--terms", type=int, default=8000)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--train-steps", type=int, default=300)
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--shards", type=int, default=1,
                    help="document partitions served by the planner/executor")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    corpus = synthesize_corpus(CorpusConfig(n_docs=args.docs, n_terms=args.terms, avg_doc_len=80))
    inv = build_inverted_index(corpus)
    li_cfg = LearnedIndexConfig(embed_dim=64, truncation_k=args.k, block_size=args.block_size)
    model = train_membership(corpus, inv, li_cfg, steps=args.train_steps, device=dev)
    lb = fit_thresholds(model, inv)
    print(f"[serve] false-negative rate {false_negative_rate(lb, inv)}")
    cfg = ServeConfig(algorithm=args.algorithm, verified=not args.no_verify,
                      n_shards=args.shards, device=str(dev))
    eng = BooleanEngine(lb, inv, li_cfg, cfg)
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
        if n_exact != args.queries:
            raise SystemExit("verified mode must be exact")
        print("[serve] verified mode: all results exact")
    s = eng.serving_stats()
    c, g = s["decode_cache"], s["guided"] or {}
    print(f"[serve] cache {c['hits']}h/{c['misses']}m/{c['evictions']}e, "
          f"probe bytes {g.get('guided_bytes', 0)} (ratio {g.get('bytes_ratio', 0.0):.3f})")


if __name__ == "__main__":
    main()
