"""phi4-mini-3.8b [arXiv:2412.08905; hf]: 32L d3072 24H (GQA kv=8) ff8192
vocab 200064 — RoPE SwiGLU GQA, tied embeddings."""
from repro_torch.common.config import ArchConfig
from repro_torch.configs.shapes import LM_SHAPES

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="lm",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    activation="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    attn_shard="seq",  # 24 heads % 16 != 0: shard attention over query seq (SP)
)
SHAPES = LM_SHAPES
# pure full attention -> long_500k skipped
SKIP_SHAPES = {"long_500k": "pure full attention: every layer needs a 512k KV; no sub-quadratic path"}
