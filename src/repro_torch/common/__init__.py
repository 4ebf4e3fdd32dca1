"""Configs and small helpers shared by every layer of the port (the
reference's mesh-placement helpers wait for the distributed slice; the
logical sharding rules are in ``common.sharding``)."""
from repro_torch.common.config import (
    ArchConfig,
    LearnedIndexConfig,
    MeshConfig,
    OptimizerConfig,
    ShapeSpec,
    TrainConfig,
)

__all__ = [
    "ArchConfig",
    "LearnedIndexConfig",
    "MeshConfig",
    "OptimizerConfig",
    "ShapeSpec",
    "TrainConfig",
]
