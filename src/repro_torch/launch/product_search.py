"""Vertical product search (the paper's §1 motivation): Boolean attribute
pre-filtering with the learned index, followed by dense retrieval scoring.

Catalogue items have attribute sets (category, brand, tags...).  A query is
a conjunctive attribute filter and a user interest vector:
  1. the learned index (Algorithm 3) filters the catalogue to candidates;
  2. dot scoring ranks the survivors;
  3. the results contain every matching item (the zero-FN guarantee, then
     exact verification).

  PYTHONPATH=src python -m repro_torch.launch.product_search [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.common.config import CorpusConfig, LearnedIndexConfig
from repro_torch.common.device import resolve_device
from repro_torch.core import fit_thresholds, init_membership
from repro_torch.data.corpus import synthesize_corpus
from repro_torch.index.build import build_inverted_index
from repro_torch.serve import BooleanEngine, ServeConfig


def run(device: str = "cuda", log=print) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    # catalogue: 3000 items ("docs"), 500 attributes ("terms")
    corpus = synthesize_corpus(
        CorpusConfig(name="catalogue", n_docs=3000, n_terms=500, avg_doc_len=12))
    inv = build_inverted_index(corpus)
    li_cfg = LearnedIndexConfig(embed_dim=32, truncation_k=32, block_size=64)
    model = init_membership(li_cfg, corpus.n_terms, corpus.n_docs, seed=0, device=dev)
    lb = fit_thresholds(model, inv)
    eng = BooleanEngine(lb, inv, li_cfg, ServeConfig(algorithm="block", verified=True,
                                                     device=str(dev)))

    # dense side: item embeddings and a user interest vector
    item_emb = rng.standard_normal((corpus.n_docs, 32)).astype(np.float32)
    user = rng.standard_normal(32).astype(np.float32)

    # query: items that carry ALL of these attributes
    filt = np.array([[2, 17, 33, -1]], dtype=np.int32)
    candidates = eng.query_batch(filt)[0]
    log(f"Boolean filter -> {len(candidates)} candidate items")

    scores = item_emb[candidates] @ user
    top = candidates[np.argsort(scores)[::-1][:10]]
    log(f"top-10 after dense scoring: {top.tolist()}")

    # exactness: no matching item was lost by the learned filter
    truth = [d for d in range(corpus.n_docs)
             if all(corpus.contains(int(t), d) for t in filt[0] if t >= 0)]
    if set(truth) != set(candidates.tolist()):
        raise AssertionError("the filtered candidates differ from the matching items")
    log(f"guarantee holds: all {len(truth)} matching items present")
    return {"candidates": len(candidates), "top": top.tolist()}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain PyTorch versions)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
