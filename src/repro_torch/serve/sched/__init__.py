from repro_torch.serve.sched.admission import AdmissionQueue, Pending
from repro_torch.serve.sched.api import (
    MODE_BOOLEAN,
    MODE_RANKED,
    REJECT_DEADLINE,
    REJECT_QUEUE_FULL,
    REJECT_SHUTDOWN,
    REJECT_TENANT_QUOTA,
    REJECT_WORKER_FAILED,
    QueryRequest,
    QueryResult,
    Rejected,
    SubmitOutcome,
    WorkerFailure,
)
from repro_torch.serve.sched.replica import (
    InlineReplica,
    ProcessReplica,
    ReplicaError,
    ReplicaGroup,
)
from repro_torch.serve.sched.session import Session

__all__ = [
    "AdmissionQueue",
    "InlineReplica",
    "MODE_BOOLEAN",
    "MODE_RANKED",
    "Pending",
    "ProcessReplica",
    "QueryRequest",
    "QueryResult",
    "REJECT_DEADLINE",
    "REJECT_QUEUE_FULL",
    "REJECT_SHUTDOWN",
    "REJECT_TENANT_QUOTA",
    "REJECT_WORKER_FAILED",
    "Rejected",
    "ReplicaError",
    "ReplicaGroup",
    "Session",
    "SubmitOutcome",
    "WorkerFailure",
]
