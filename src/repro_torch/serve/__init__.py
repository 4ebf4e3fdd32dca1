"""Boolean and ranked serving: planner, shard executors, the BooleanEngine
facade and the continuous-batching scheduler (``serve.sched.Session``)."""
from repro_torch.rank.score import TopKResult
from repro_torch.serve.boolean import BooleanEngine
from repro_torch.serve.cache import CostLRU
from repro_torch.serve.config import ObsConfig, RankedConfig, SchedConfig, ServeConfig
from repro_torch.serve.planner import (
    BatchPlan,
    QueryPlan,
    RankedQueryPlan,
    ShardPlan,
    plan_batch,
    plan_ranked,
    ranked_run_mask,
)
from repro_torch.serve.sched import (
    QueryRequest,
    QueryResult,
    Rejected,
    Session,
    WorkerFailure,
)
from repro_torch.serve.shard import ShardEngine, shard_ranges, slice_bloom

__all__ = [
    "BatchPlan",
    "BooleanEngine",
    "CostLRU",
    "ObsConfig",
    "QueryPlan",
    "QueryRequest",
    "QueryResult",
    "RankedConfig",
    "RankedQueryPlan",
    "Rejected",
    "SchedConfig",
    "ServeConfig",
    "Session",
    "ShardEngine",
    "ShardPlan",
    "TopKResult",
    "WorkerFailure",
    "plan_batch",
    "plan_ranked",
    "ranked_run_mask",
    "shard_ranges",
    "slice_bloom",
]
