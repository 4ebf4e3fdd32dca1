"""meshgraphnet [arXiv:2010.03409]: 15 layers, hidden 128, sum aggregator,
2-layer MLPs. Encode-process-decode over padded graphs."""
from repro_torch.common.config import ArchConfig
from repro_torch.configs.shapes import GNN_SHAPES

CONFIG = ArchConfig(
    name="meshgraphnet",
    family="gnn",
    gnn_layers=15,
    gnn_hidden=128,
    gnn_mlp_layers=2,
    gnn_aggregator="sum",
    node_feat_dim=128,  # overridden per shape (d_feat)
    edge_feat_dim=4,
    gnn_out_dim=2,
)
SHAPES = GNN_SHAPES
SKIP_SHAPES = {}
