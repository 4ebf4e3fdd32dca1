"""gemma2-2b [arXiv:2408.00118; hf]: 26L d2304 8H (GQA kv=4) ff9216
vocab 256000 — local(4096)+global alternating, logit softcaps, GeGLU,
head_dim 256, post-norms, embedding scale."""
from repro_torch.common.config import ArchConfig
from repro_torch.configs.shapes import LM_SHAPES

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="lm",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    activation="geglu",
    attn_types=("local", "global"),
    window_size=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    embed_scale=True,
    tie_embeddings=True,
)
SHAPES = LM_SHAPES
SKIP_SHAPES = {}  # hybrid local/global: long_500k runs (local layers keep 4k ring KV)
