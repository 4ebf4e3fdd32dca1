"""fm [Rendle ICDM'10]: 39 sparse fields, embed 10, pairwise interactions
via the O(nk) sum-square trick. Criteo layout: 26 categorical vocabs +
13 bucketized numeric fields (1000 buckets each)."""
from repro_torch.common.config import ArchConfig
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.recsys import CRITEO_VOCABS

CONFIG = ArchConfig(
    name="fm",
    family="recsys",
    n_sparse=39,
    embed_dim=10,
    interaction="fm-2way",
    vocab_sizes=tuple(CRITEO_VOCABS) + (1000,) * 13,
)
SHAPES = RECSYS_SHAPES
SKIP_SHAPES = {}
