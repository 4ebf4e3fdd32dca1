"""Configs and small helpers shared by every layer of the port (the
logical sharding rules and their placement on a device mesh are in
``common.sharding``)."""
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
