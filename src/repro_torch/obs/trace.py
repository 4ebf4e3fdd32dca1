"""Zero-dependency span tracer for the query path.

One ``Tracer`` collects nestable, attributed spans and exports them in the
Chrome-trace JSON format (open ``chrome://tracing`` or https://ui.perfetto.dev
and drop the file in).  The design constraint is the serving hot path: when
no tracer is installed, ``span()`` returns a shared no-op singleton — no
object allocation, no clock read — so the trace-off cost is one thread-local
attribute lookup per call site.

Spans are *ambient*: instead of threading a tracer through every layer
(facade → planner → shard → guided probes → kernel dispatch), an engine
installs its tracer for the duration of a batch with ``activate`` and any
code underneath — including the kernel wrappers in repro_torch.kernels —
opens spans through the module-level ``span()``.  Activation is thread-local; the
facade re-activates inside worker threads when the probe phase fans out, so
spans carry the worker's tid and the trace shows real parallelism.

Spans are host time.  Kernel launches are asynchronous, so a ``kernel.*``
span covers its wrapper's host bridge up to the wrapper's own
synchronisation (the result copy it makes, ``kernels.cuda.fetch``), and a
wrapper that hands back device tensors closes its span at the launch.
Nothing synchronises the card for tracing: read no span as device time.

Span timestamps are ``perf_counter_ns`` relative to the tracer's epoch,
reported in microseconds (the Chrome trace unit).  Attributes are free-form
key/values rendered into the event's ``args``; callers attach measured
counters after entry via ``handle.set(bytes=...)``.

Spans cross process boundaries: a worker runs its own ``Tracer``, ships
finished spans as wire dicts (``drain_wire`` — absolute worker-clock
nanoseconds, so no epoch needs to travel), and the host maps them onto its
own timeline with the replica's estimated clock offset (obs/collate.py).
``Span.pid`` keeps each process in its own Chrome-trace lane;
``set_process_name`` labels the lanes.  The ``TraceContext`` carried with
each IPC request tells the worker whether to trace at all, so the trace-off
path still costs nothing on the wire.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Span:
    """One finished span (ts/dur in microseconds since the tracer epoch)."""

    name: str
    ts_us: float
    dur_us: float
    tid: int
    depth: int  # nesting level inside its thread (0 = top-level)
    attrs: dict = field(default_factory=dict)
    pid: int = 0  # 0 = the tracer's own process; workers keep their os pid


@dataclass
class TraceContext:
    """Per-request observability contract carried through worker IPC.

    Pickles with the request message; the worker reads it to decide what to
    ship back (span buffer, probe records) and tags its spans with
    ``trace_id`` so one request renders end-to-end across pid lanes.
    """

    trace_id: int = 0
    trace: bool = False  # ship finished spans back with the response
    probe: bool = False  # ship routed-probe records back with the response


class _NullSpan:
    """Shared no-op handle: the entire trace-off path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()

_ambient = threading.local()


def current() -> "Tracer | None":
    """The tracer installed on this thread, or None (tracing off)."""
    return getattr(_ambient, "tracer", None)


def span(name: str, **attrs) -> "_SpanHandle | _NullSpan":
    """Open a span on the ambient tracer; the no-op singleton when off."""
    tracer = getattr(_ambient, "tracer", None)
    if tracer is None:
        return NULL_SPAN
    return tracer.span(name, **attrs)


class _Activation:
    """Context manager installing a tracer as this thread's ambient one."""

    __slots__ = ("_tracer", "_prev")

    def __init__(self, tracer: "Tracer | None"):
        self._tracer = tracer

    def __enter__(self) -> "Tracer | None":
        self._prev = getattr(_ambient, "tracer", None)
        if self._tracer is not None:
            _ambient.tracer = self._tracer
        return self._tracer

    def __exit__(self, *exc) -> bool:
        if self._tracer is not None:
            _ambient.tracer = self._prev
        return False


def activate(tracer: "Tracer | None") -> _Activation:
    """Install ``tracer`` for a with-block; ``activate(None)`` is a no-op
    (it leaves any outer activation in place, so a traced caller still sees
    spans from an engine whose own config carries no tracer)."""
    return _Activation(tracer)


class _SpanHandle:
    """Live span: records a Span onto its tracer at ``__exit__``."""

    __slots__ = ("_tracer", "name", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> "_SpanHandle":
        """Attach measured attributes (bytes touched, counts) after entry."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_SpanHandle":
        self._tracer._stack().append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        tracer = self._tracer
        stack = tracer._stack()
        stack.pop()
        tracer._record(
            Span(
                name=self.name,
                ts_us=(self._t0 - tracer.epoch_ns) / 1e3,
                dur_us=(t1 - self._t0) / 1e3,
                tid=threading.get_ident(),
                depth=len(stack),
                attrs=self.attrs,
            )
        )
        return False


class Tracer:
    """Collects spans; thread-safe; exports Chrome-trace JSON."""

    def __init__(self, name: str = "repro-serve"):
        self.name = name
        self.epoch_ns = time.perf_counter_ns()
        self.spans: list[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._process_names: dict[int, str] = {0: name}

    # ------------------------------------------------------------- record
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, s: Span) -> None:
        with self._lock:
            self.spans.append(s)

    def add_span(self, s: Span) -> None:
        """Append an externally constructed span (collated worker spans,
        retroactive queue-wait spans) onto this tracer's timeline."""
        with self._lock:
            self.spans.append(s)

    def set_process_name(self, pid: int, label: str) -> None:
        """Label a pid lane in the exported trace (host lane 0 is prenamed)."""
        with self._lock:
            self._process_names[int(pid)] = label

    def span(self, name: str, **attrs) -> _SpanHandle:
        return _SpanHandle(self, name, attrs)

    def activate(self) -> _Activation:
        return _Activation(self)

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()
        self.epoch_ns = time.perf_counter_ns()

    # --------------------------------------------------------------- wire
    def drain_wire(self) -> list[dict]:
        """Pop finished spans as picklable wire dicts for IPC shipping.

        Timestamps go out as *absolute* ``perf_counter_ns`` values
        (``ts_ns = epoch_ns + ts_us*1e3``): the receiving host subtracts the
        replica's estimated clock offset and re-bases onto its own epoch
        (obs/collate.span_from_wire), so the epoch itself never travels.
        The epoch is kept — a worker drains after every request without
        restarting its clock.
        """
        with self._lock:
            spans, self.spans = self.spans, []
        return [
            {
                "name": s.name,
                "ts_ns": int(self.epoch_ns + s.ts_us * 1e3),
                "dur_us": s.dur_us,
                "tid": s.tid,
                "depth": s.depth,
                "attrs": s.attrs,
            }
            for s in spans
        ]

    # ------------------------------------------------------------- export
    def chrome_trace(self) -> dict:
        """The trace as a Chrome/Perfetto ``traceEvents`` document.

        Every span becomes one complete ("X") event; nesting is implied by
        (pid, tid, ts, dur) containment, which the viewers render as stacks.
        Worker spans collated from process replicas keep their own pid, so
        each replica renders as its own named process lane ("M" metadata
        events carry the labels).
        """
        with self._lock:
            spans = list(self.spans)
            names = dict(self._process_names)
        events = [
            {
                "name": s.name,
                "cat": "serve",
                "ph": "X",
                "ts": s.ts_us,
                "dur": s.dur_us,
                "pid": s.pid,
                "tid": s.tid,
                "args": dict(s.attrs),
            }
            for s in spans
        ]
        n_spans = len(events)
        events += [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": label},
            }
            for pid, label in sorted(names.items())
        ]
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"tracer": self.name, "n_spans": n_spans},
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
