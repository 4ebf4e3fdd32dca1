"""Assigned input-shape sets (verbatim from the assignment grid)."""
from __future__ import annotations

from repro_torch.common.config import ShapeSpec

LM_SHAPES = (
    ShapeSpec(name="train_4k", kind="train", seq_len=4096, global_batch=256),
    ShapeSpec(name="prefill_32k", kind="prefill", seq_len=32768, global_batch=32),
    ShapeSpec(name="decode_32k", kind="decode", seq_len=32768, global_batch=128),
    ShapeSpec(name="long_500k", kind="decode", seq_len=524288, global_batch=1),
)

GNN_SHAPES = (
    ShapeSpec(name="full_graph_sm", kind="train", n_nodes=2708, n_edges=10556, d_feat=1433),
    ShapeSpec(
        name="minibatch_lg",
        kind="train",
        n_nodes=232_965,
        n_edges=114_615_892,
        batch_nodes=1024,
        fanout=(15, 10),
    ),
    ShapeSpec(name="ogb_products", kind="train", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100),
    ShapeSpec(name="molecule", kind="train", n_nodes=30, n_edges=64, n_graphs=128),
)

RECSYS_SHAPES = (
    ShapeSpec(name="train_batch", kind="train", global_batch=65536),
    ShapeSpec(name="serve_p99", kind="serve", global_batch=512),
    ShapeSpec(name="serve_bulk", kind="serve", global_batch=262_144),
    ShapeSpec(name="retrieval_cand", kind="retrieval", global_batch=1, n_candidates=1_000_000),
)
