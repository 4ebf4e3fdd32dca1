"""The paper's own system config: learned index for Boolean retrieval.

Serve shapes: batched conjunctive queries against a doc-embedding index.
(The paper's s = 512-bit worst case = 128-dim fp32 embeddings.)"""
from repro_torch.common.config import ArchConfig, LearnedIndexConfig, ShapeSpec

CONFIG = ArchConfig(name="learned-index", family="learned_index", embed_dim=128)
LEARNED_INDEX = LearnedIndexConfig(
    algorithm="two_tier",
    embed_dim=128,
    truncation_k=4000,
    block_size=1024,
    replace_df_threshold=4000,
)
# query serving over a ClueWeb-scale doc table (50.2M docs), 8-term queries
SHAPES = (
    ShapeSpec(name="serve_queries", kind="serve", global_batch=4096, seq_len=8,
              n_candidates=50_220_423),
    ShapeSpec(name="serve_block", kind="serve", global_batch=1024, seq_len=8,
              n_candidates=50_220_423),
)
SKIP_SHAPES = {}
