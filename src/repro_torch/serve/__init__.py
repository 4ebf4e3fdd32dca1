"""Boolean and ranked serving: planner, shard executors, the BooleanEngine
facade and the continuous-batching scheduler (``serve.sched.Session``)."""
from repro_torch.serve.boolean import BooleanEngine
from repro_torch.serve.cache import CostLRU
from repro_torch.serve.config import ObsConfig, RankedConfig, SchedConfig, ServeConfig
from repro_torch.serve.sched import (
    QueryRequest,
    QueryResult,
    Rejected,
    Session,
    WorkerFailure,
)

__all__ = [
    "BooleanEngine",
    "CostLRU",
    "ObsConfig",
    "QueryRequest",
    "QueryResult",
    "RankedConfig",
    "Rejected",
    "SchedConfig",
    "ServeConfig",
    "Session",
    "WorkerFailure",
]
