"""Boolean serving: planner, shard executors and the BooleanEngine facade."""
from repro_torch.serve.boolean import BooleanEngine
from repro_torch.serve.cache import CostLRU
from repro_torch.serve.config import ServeConfig

__all__ = ["BooleanEngine", "CostLRU", "ServeConfig"]
