"""One rank's share of the web-scale learned index, served by the port's
``launch/dryrun_learned_index.py:exhaustive_step``.

Set-up makes the rank's tables on the device from the seed
(``gen/embeddings.py``) and a pool of query batches (``gen/queries.py``'s
Zipf draws over the rank's terms); the step is the program.  ``check()``
holds sampled batches' result words to ``reference/membership.py``, outside
the configuration's numeric margin of tau.

The control (``control=True``) puts the reference, computed in bfloat16, in
the step's place.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench import roofline
from port_bench.gen import queries as gen_queries
from port_bench.gen.embeddings import learned_index_tables
from port_bench.reference import membership as ref


class LearnedIndexStep:
    def __init__(self, cfg: dict, seed: int, device, setup, control: bool = False):
        self.device = torch.device(device)
        shard = cfg["shard"]
        self.n_docs, self.n_terms, self.embed = shard["docs"], shard["terms"], shard["embed"]
        self.width = int(cfg["query_width"])
        with setup.stage("tables"):
            self.params = learned_index_tables(self.n_docs, self.n_terms, self.embed, seed,
                                               self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
        if control:
            self._step = lambda params, q: ref.words(params, q, "bf16")
        else:
            from repro_torch.launch.dryrun_learned_index import exhaustive_step

            self._step = exhaustive_step
        self.footprint: dict = {}

    def batch_pool(self, rng: np.random.Generator, n_batches: int, batch: int,
                   parts: list[dict]) -> tuple[torch.Tensor, list[dict]]:
        """-> ((n_batches, batch, width) int32 term ids on the device, each
        batch's work); the rank's terms are ranked by their id, and each
        batch is drawn on its own."""
        dfs = np.arange(self.n_terms, 0, -1)  # term 0 first, as the ranks go
        vocab = gen_queries.ranked_vocab(dfs)
        pool = np.stack([gen_queries.mix(rng, batch, parts, dfs=dfs, width=self.width,
                                         vocab=vocab) for _ in range(n_batches)])
        work = [self.work(int((b >= 0).sum())) for b in pool]
        return torch.from_numpy(pool).to(self.device), work

    def step(self, queries: torch.Tensor) -> torch.Tensor:
        return self._step(self.params, queries)

    def work(self, slots: int) -> dict:
        """Operations and least time of one step of ``slots`` valid slots."""
        t, bound = roofline.membership_least_time(slots, self.n_docs, self.embed)
        return {"slots": slots, "flops": roofline.membership_flops(slots, self.n_docs, self.embed),
                "least_s": t, "bound_by": bound}

    def close(self) -> None:
        """The step keeps no state between calls; the tables are the inputs."""

    def check(self, sampled: list[tuple[torch.Tensor, torch.Tensor]]) -> dict[str, dict]:
        outside = within = 0
        for queries, got in sampled:
            c = ref.compare(self.params, queries, got)
            outside += c["outside"]
            within += c["within"]
        return {"bits_outside_margin": {"value": outside, "limit": 0}}


def build(cfg: dict, seed: int, device, setup, control: bool = False) -> LearnedIndexStep:
    return LearnedIndexStep(cfg, seed, device, setup, control)
