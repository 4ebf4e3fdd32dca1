"""bst [arXiv:1905.06874]: Behavior Sequence Transformer (Alibaba).
embed 32, hist len 20, 1 block, 8 heads, MLP 1024-512-256. Item vocab 4M
(Taobao scale; the paper does not publish the exact cardinality)."""
from repro_torch.common.config import ArchConfig
from repro_torch.configs.shapes import RECSYS_SHAPES

CONFIG = ArchConfig(
    name="bst",
    family="recsys",
    embed_dim=32,
    hist_len=20,
    n_blocks=1,
    n_heads=8,
    top_mlp=(1024, 512, 256),
    interaction="transformer-seq",
    vocab_sizes=(4_000_000,),
)
SHAPES = RECSYS_SHAPES
SKIP_SHAPES = {}
