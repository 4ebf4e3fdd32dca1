"""A learned-index Boolean deployment served through the port's ``Session``.

Set-up, each stage timed: the collection (``gen/corpus.py``, on the
device), the port's inverted index, its membership model trained for the
configured steps, the zero-false-negative thresholds, a ``BooleanEngine``
over ``shards`` document shards whose tier-2 stores are built here, the
shard-store saved under ``$TMPDIR``, and a ``Session`` with ``replicas``
spawned process replicas per shard, warmed on every batch bucket.  Requests
go through ``Session.submit_async``; ``close()`` ends the session, and
``check()`` then holds every answer to the brute force of
``reference/boolean.py``.

The control (``control=True``) is the same deployment with verification
switched off (``ServeConfig.verified = False``): its answers are the learned
Bloom filter's candidates, which the configuration's exactness forbids.
"""
from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from port_bench.devtrace import card_memory_used_bytes
from port_bench.gen import corpus as gen_corpus
from port_bench.gen import queries as gen_queries
from port_bench.reference.boolean import Conjunctions


def _tensor_bytes(lb) -> int:
    """Bytes of the learned model that ``BooleanEngine.from_store`` takes:
    its tables, bias and head, the thresholds and the backup keys."""
    m = lb.model
    tensors = [m.term_embed.weight, m.doc_embed.weight, m.bias, lb.tau]
    for layer in m.head_layers():
        tensors += list(layer.values())
    return int(sum(t.numel() * t.element_size() for t in tensors) + lb.backup_keys.nbytes)


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total


class BooleanSession:
    def __init__(self, cfg: dict, seed: int, device, setup, control: bool = False):
        from repro_torch.common.config import CorpusConfig, LearnedIndexConfig
        from repro_torch.core.learned_bloom import fit_thresholds
        from repro_torch.data.corpus import Corpus
        from repro_torch.index.build import build_inverted_index
        from repro_torch.launch.serve import train_membership
        from repro_torch.serve import BooleanEngine, ServeConfig
        from repro_torch.serve.config import RankedConfig, SchedConfig

        col, model, serve = cfg["collection"], cfg["model"], cfg["serve"]
        self.device = torch.device(device)
        # the card's use before this run touches it (the driver's memory reading is net of it)
        self.card_base_bytes = (card_memory_used_bytes() or 0) if self.device.type == "cuda" else 0
        self.max_terms = int(serve["max_query_terms"])
        with setup.stage("corpus"):
            arrays = gen_corpus.synthesize(col["n_docs"], col["n_terms"], col["avg_doc_len"],
                                           col["zipf_a"], col["zipf_b"], seed, self.device)
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        self.doc_offsets, self.term_ids = arrays["doc_offsets"], arrays["term_ids"]
        self.n_terms = int(col["n_terms"])
        self.dfs = gen_corpus.document_frequencies(self.term_ids, self.n_terms)
        corpus = Corpus(cfg=CorpusConfig(name=cfg["name"], n_docs=col["n_docs"],
                                         n_terms=col["n_terms"], avg_doc_len=col["avg_doc_len"],
                                         zipf_a=col["zipf_a"], zipf_b=col["zipf_b"]),
                        doc_offsets=arrays["doc_offsets"], term_ids=arrays["term_ids"],
                        term_freqs=arrays["term_freqs"])
        with setup.stage("index"):
            inv = build_inverted_index(corpus)
        li_cfg = LearnedIndexConfig(algorithm=serve["algorithm"], embed_dim=model["embed_dim"],
                                    block_size=model["block_size"],
                                    truncation_k=model["truncation_k"],
                                    replace_df_threshold=model["truncation_k"])
        with setup.stage("train"):
            mm = train_membership(corpus, inv, li_cfg, steps=model["train_steps"],
                                  batch_size=model["train_batch"], seed=seed % 2 ** 63,
                                  device=self.device, log=lambda *_: None)
        with setup.stage("thresholds"):
            lb = fit_thresholds(mm, inv)
        del corpus
        scfg = ServeConfig(algorithm=serve["algorithm"], verified=not control,
                           max_query_terms=self.max_terms, n_shards=serve["shards"],
                           device=str(self.device), ranked=RankedConfig(enabled=False),
                           sched=SchedConfig(max_batch=serve["max_batch"],
                                             n_replicas=serve["replicas"]))
        self.engine = BooleanEngine(lb, inv, li_cfg, scfg)
        with setup.stage("tier2_build"):
            for sh in self.engine.shards:
                sh.tier2
        self.store = tempfile.mkdtemp(prefix="port_bench_store_")
        self.session = None
        try:
            with setup.stage("store"):
                self.engine.save(self.store)
            with setup.stage("session"):
                from repro_torch.serve import Session

                self.session = Session(self.engine, store_dir=self.store)
            with setup.stage("spawn_warm"):
                self.session.warm()
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()  # set-up's cached blocks are not the deployment's
        except BaseException:
            self.close()  # no replica or store outlives a failed set-up
            raise
        self.footprint = {
            "postings": int(self.term_ids.size),
            "store_bytes": _dir_bytes(self.store),
            "model_bytes": _tensor_bytes(lb),
            "eq2_bits": int(sum(self.engine.memory_report().values())),
        }

    # ---------------------------------------------------------- traffic
    def query_pool(self, rng: np.random.Generator, n: int, parts: list[dict],
                   strata: int | None = None) -> np.ndarray:
        return gen_queries.mix(rng, n, parts, dfs=self.dfs, width=self.max_terms, strata=strata)

    def submit(self, terms: np.ndarray):
        from repro_torch.serve import QueryRequest

        return self.session.submit_async(QueryRequest(terms=terms))

    def set_trace(self, tracer) -> None:
        self.engine.cfg.obs.trace = tracer

    # -------------------------------------------------------------- end
    def close(self) -> None:
        """End the session and its replicas, free the program's state."""
        try:
            if self.session is not None:
                self.session.close()
        finally:
            self.session = self.engine = None
            shutil.rmtree(self.store, ignore_errors=True)
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def check(self, answered: list[tuple[np.ndarray, np.ndarray]]) -> dict[str, dict]:
        """Every (query terms, served ids) against the brute force."""
        ref = Conjunctions(self.doc_offsets, self.term_ids, self.n_terms, self.device)
        wrong = sum(not ref.is_right(terms, ids) for terms, ids in answered)
        return {"wrong_answers": {"value": wrong, "limit": 0}}


def build(cfg: dict, seed: int, device, setup, control: bool = False) -> BooleanSession:
    return BooleanSession(cfg, seed, device, setup, control)
