"""Neighbor sampler for minibatch GNN training (GraphSAGE-style fanout).

Host-side numpy over a CSR adjacency (the reference's, call for call, so a
seed gives identical arrays); emits fixed-size padded subgraphs so the
train step sees static shapes. Fanout (15, 10) over batch_nodes
seeds gives ≤ seeds·(1 + 15 + 150) nodes and ≤ seeds·(15 + 150) edges;
padding fills the rest.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray  # (N+1,)
    indices: np.ndarray  # (nnz,)
    n_nodes: int

    @staticmethod
    def random(n_nodes: int, avg_degree: int, seed: int = 0) -> "CSRGraph":
        rng = np.random.default_rng(seed)
        deg = rng.poisson(avg_degree, n_nodes).astype(np.int64)
        indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.cumsum(deg, out=indptr[1:])
        indices = rng.integers(0, n_nodes, size=int(indptr[-1])).astype(np.int32)
        return CSRGraph(indptr, indices, n_nodes)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]


def sample_subgraph(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanout: tuple[int, ...],
    *,
    max_nodes: int,
    max_edges: int,
    rng: np.random.Generator,
) -> dict[str, np.ndarray]:
    """Returns padded {senders, receivers, node_ids, node_mask, edge_mask}."""
    node_ids: list[int] = list(dict.fromkeys(int(s) for s in seeds))
    local = {v: i for i, v in enumerate(node_ids)}
    senders: list[int] = []
    receivers: list[int] = []
    frontier = list(node_ids)
    for f in fanout:
        nxt: list[int] = []
        for v in frontier:
            nbrs = graph.neighbors(v)
            if len(nbrs) == 0:
                continue
            pick = rng.choice(nbrs, size=min(f, len(nbrs)), replace=False)
            for u in pick:
                u = int(u)
                if u not in local:
                    if len(node_ids) >= max_nodes:
                        continue
                    local[u] = len(node_ids)
                    node_ids.append(u)
                    nxt.append(u)
                if len(senders) < max_edges:
                    senders.append(local[u])
                    receivers.append(local[v])
        frontier = nxt
    n, m = len(node_ids), len(senders)
    out = {
        "node_ids": np.zeros(max_nodes, np.int32),
        "senders": np.zeros(max_edges, np.int32),
        "receivers": np.zeros(max_edges, np.int32),
        "node_mask": np.zeros(max_nodes, np.float32),
        "edge_mask": np.zeros(max_edges, np.float32),
    }
    out["node_ids"][:n] = node_ids
    out["senders"][:m] = senders
    out["receivers"][:m] = receivers
    out["node_mask"][:n] = 1.0
    out["edge_mask"][:m] = 1.0
    return out


def subgraph_budget(batch_nodes: int, fanout: tuple[int, ...]) -> tuple[int, int]:
    """(max_nodes, max_edges) for a fanout sample from batch_nodes seeds."""
    nodes, frontier, edges = batch_nodes, batch_nodes, 0
    for f in fanout:
        edges += frontier * f
        frontier *= f
        nodes += frontier
    return nodes, edges
