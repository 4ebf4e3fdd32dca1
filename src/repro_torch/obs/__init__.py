"""Observability for the serving stack: tracing, metrics, probe logging.

The port's own copy of the reference's ``repro.obs`` (pure Python): the same
names, snapshots, Chrome-trace documents, probe-log JSONL and Prometheus
text, so either package reads what the other writes.

  trace.py     nestable span tracer, Chrome-trace/Perfetto JSON export,
               ambient activation so deep layers need no tracer plumbing;
               TraceContext + span wire format for process-replica IPC
  collate.py   replica clock-offset estimation (min-RTT ping) and merging
               shipped worker spans onto the host timeline in pid lanes
  metrics.py   counters / gauges / fixed-bucket histograms behind one
               Registry.snapshot() / Registry.reset() pair
  probelog.py  per-(query, term, shard) routed-probe JSONL records — the
               training data for the learned guided-vs-decode cost model —
               with size-capped rotation and worker->host forwarding
  slo.py       rolling per-tenant deadline-hit-rate / p99 / burn-rate over
               a sliding window (Session.slo_report feeds from it)
  export.py    Prometheus text-format rendering of any Registry snapshot
"""
from repro_torch.obs.collate import (
    estimate_clock_offset,
    ingest_worker_spans,
    nesting_violations,
    span_from_wire,
)
from repro_torch.obs.export import render_prometheus, write_prometheus
from repro_torch.obs.metrics import Counter, Gauge, Histogram, Registry
from repro_torch.obs.probelog import ProbeLog, ProbeRecord
from repro_torch.obs.slo import SLOMonitor
from repro_torch.obs.trace import (
    NULL_SPAN,
    Span,
    TraceContext,
    Tracer,
    activate,
    current,
    span,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "NULL_SPAN",
    "ProbeLog",
    "ProbeRecord",
    "Registry",
    "SLOMonitor",
    "Span",
    "TraceContext",
    "Tracer",
    "activate",
    "current",
    "estimate_clock_offset",
    "ingest_worker_spans",
    "nesting_violations",
    "render_prometheus",
    "span",
    "span_from_wire",
    "write_prometheus",
]
