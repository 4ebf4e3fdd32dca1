"""Prometheus text-format rendering of a Registry snapshot.

``Registry.snapshot()`` is a nested dict: scalars, histogram summaries
(dicts with count/sum/mean/min/max/p50/p90/p99), per-shard lists, and
free-form collector sections.  ``render_prometheus`` flattens that into the
Prometheus text exposition format (v0.0.4) so any scrape target — a
sidecar, a pushgateway shim, a file watched by node_exporter's textfile
collector — sees the serving stack's metrics without a new dependency:

  * scalars become gauges:      repro_sched_batches 12
  * histogram summaries become Prometheus *summaries*:
        repro_sched_queue_us{quantile="0.5"} 104.2
        repro_sched_queue_us_sum 4210.0
        repro_sched_queue_us_count 40
    (plus _min/_max gauges — fixed-bucket percentiles are already computed
    registry-side, so a summary is the honest encoding, not _bucket lines)
  * lists (the per-shard sections) label elements with {idx="i"}
  * booleans render 0/1; strings are skipped (Prometheus has no string
    sample type and labels-from-values would explode cardinality)

Metric names are sanitized to ``[a-zA-Z0-9_]`` and the output is sorted, so
two snapshots of the same registry diff cleanly.
"""
from __future__ import annotations

import re

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

# a dict with at least these keys renders as a summary (the Histogram
# snapshot shape; collectors echoing the same shape get the same treatment)
_HIST_KEYS = {"count", "sum", "p50", "p99"}

_QUANTILES = (("p50", "0.5"), ("p90", "0.9"), ("p99", "0.99"))


def _sanitize(part: str) -> str:
    return _NAME_RE.sub("_", str(part))


def _labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def _render_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    return repr(float(v)) if isinstance(v, float) else str(int(v))


def _walk(node, name_parts: tuple, labels: tuple, lines: list, types: dict) -> None:
    if isinstance(node, dict):
        if _HIST_KEYS <= set(node):
            name = "_".join(name_parts)
            types.setdefault(name, "summary")
            for key, q in _QUANTILES:
                if key in node:
                    lines.append(
                        f"{name}{_labels(labels + (('quantile', q),))} "
                        f"{_render_value(node[key])}"
                    )
            lines.append(f"{name}_sum{_labels(labels)} {_render_value(node['sum'])}")
            lines.append(
                f"{name}_count{_labels(labels)} {_render_value(node['count'])}"
            )
            for extra in ("min", "max", "mean"):
                if extra in node:
                    ename = f"{name}_{extra}"
                    types.setdefault(ename, "gauge")
                    lines.append(
                        f"{ename}{_labels(labels)} {_render_value(node[extra])}"
                    )
            return
        for k, v in node.items():
            _walk(v, name_parts + (_sanitize(k),), labels, lines, types)
        return
    if isinstance(node, (list, tuple)):
        for i, item in enumerate(node):
            _walk(item, name_parts, labels + (("idx", str(i)),), lines, types)
        return
    if isinstance(node, str) or node is None:
        return  # no string sample type; skip rather than invent labels
    name = "_".join(name_parts)
    types.setdefault(name, "gauge")
    lines.append(f"{name}{_labels(labels)} {_render_value(node)}")


def render_prometheus(snapshot: dict, *, prefix: str = "repro") -> str:
    """A Registry snapshot (or any nested dict of metrics) as Prometheus
    text exposition; deterministic (sorted) and dependency-free."""
    lines: list[str] = []
    types: dict[str, str] = {}
    _walk(snapshot, (_sanitize(prefix),) if prefix else (), (), lines, types)
    lines.sort()
    out: list[str] = []
    typed: set[str] = set()
    for line in lines:
        metric = line.split("{", 1)[0].split(" ", 1)[0]
        base = metric
        for suffix in ("_sum", "_count"):
            if base.endswith(suffix) and base[: -len(suffix)] in types:
                base = base[: -len(suffix)]
        if base in types and base not in typed:
            typed.add(base)
            out.append(f"# TYPE {base} {types[base]}")
        out.append(line)
    return "\n".join(out) + "\n" if out else ""


def write_prometheus(snapshot: dict, path: str, *, prefix: str = "repro") -> None:
    """Render ``snapshot`` to ``path`` (textfile-collector handoff)."""
    with open(path, "w") as f:
        f.write(render_prometheus(snapshot, prefix=prefix))
