"""Configs and small helpers shared by every layer of the port (the
reference's LM-side ``ArchConfig``, ``MeshConfig`` and sharding helpers are
not ported)."""
from repro_torch.common.config import LearnedIndexConfig, OptimizerConfig, TrainConfig

__all__ = [
    "LearnedIndexConfig",
    "OptimizerConfig",
    "TrainConfig",
]
