"""mind [arXiv:1904.08030]: multi-interest capsule routing. embed 64,
4 interests, 3 routing iterations, hist len 50, item vocab 1M."""
from repro_torch.common.config import ArchConfig
from repro_torch.configs.shapes import RECSYS_SHAPES

CONFIG = ArchConfig(
    name="mind",
    family="recsys",
    embed_dim=64,
    n_interests=4,
    capsule_iters=3,
    hist_len=50,
    interaction="multi-interest",
    vocab_sizes=(1_000_000,),
)
SHAPES = RECSYS_SHAPES
SKIP_SHAPES = {}
