"""dlrm-mlperf [arXiv:1906.00091]: MLPerf DLRM (Criteo 1TB). 13 dense,
26 sparse (MLPerf vocabs, ~188M rows total), embed 128,
bot 512-256-128, top 1024-1024-512-256-1, dot interaction."""
from repro_torch.common.config import ArchConfig
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.recsys import CRITEO_VOCABS

CONFIG = ArchConfig(
    name="dlrm-mlperf",
    family="recsys",
    n_dense=13,
    n_sparse=26,
    embed_dim=128,
    bot_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    interaction="dot",
    vocab_sizes=tuple(CRITEO_VOCABS),
)
SHAPES = RECSYS_SHAPES
SKIP_SHAPES = {}
