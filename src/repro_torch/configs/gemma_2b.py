"""gemma-2b [arXiv:2403.08295; hf]: 18L d2048 8H (MQA kv=1) ff16384
vocab 256000 — GeGLU, head_dim 256, embedding scale."""
from repro_torch.common.config import ArchConfig
from repro_torch.configs.shapes import LM_SHAPES

CONFIG = ArchConfig(
    name="gemma-2b",
    family="lm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    embed_scale=True,
    tie_embeddings=True,
)
SHAPES = LM_SHAPES
SKIP_SHAPES = {"long_500k": "pure full attention: every layer needs a 512k KV; no sub-quadratic path"}
