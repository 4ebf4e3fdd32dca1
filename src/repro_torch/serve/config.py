"""Serving configuration: one ServeConfig, three nested sub-configs, plus
the device the engine runs on.

``ServeConfig`` grew one flat flag per subsystem until the scheduler would
have added a tenth; the knobs now group by the component that reads them:

  * ``ServeConfig.obs``    — observability handles (span tracer, metrics
    registry, probe log); repro_torch.obs reads these and nothing else does;
  * ``ServeConfig.ranked`` — the ranked (top-k) tier: payload quantization,
    MaxScore exhaustive cutoff, bm25_score and fused_topk kernels;
  * ``ServeConfig.sched``  — the continuous-batching scheduler
    (serve/sched): batch coalescing, admission bounds, tenant quotas,
    deadlines, process-replica fan-out.

Engine-core flags (algorithm, verification, sharding, guided probes, cache
budget, device) stay top-level — every layer reads them.  ``device``
(default ``cuda``) is where candidate masks, probes, decodes and scoring
run; it travels in ``worker_spec()``, so a process replica serves on the
device its parent's engine does.

``use_kernel``, ``guided_kernel`` and ``SchedConfig.compile_cache_dir`` are
accepted for parity with the reference but select nothing here: on a CUDA
device candidate masks, guided probes and decodes always run on the port's
kernels, and on the CPU always on their plain versions; and the port has
no XLA compilation cache for workers to share (its kernels are shared
libraries built once, see ``kernels/cuda.py``).

Backwards compatibility: the old flat kwargs (``ServeConfig(trace=...,
payload_bits=4, ranked=False)``) are still accepted — they land in the right
sub-config and raise a ``DeprecationWarning`` — and the old flat attributes
remain readable/writable as properties forwarding to the sub-configs, so
``eng.cfg.trace = tracer`` keeps working.  ``shard_workers`` (the retired
thread-pool fan-out, superseded by ``sched.n_replicas`` process replicas) is
accepted and ignored with a warning.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # handles only; never imported at runtime from here
    from repro_torch.obs.metrics import Registry
    from repro_torch.obs.probelog import ProbeLog
    from repro_torch.obs.slo import SLOMonitor
    from repro_torch.obs.trace import Tracer


@dataclass
class ObsConfig:
    """Observability handles (all opt-in; None costs ~nothing).

    With a tracer and/or probe log installed, the scheduler forwards a
    TraceContext to process replicas, which ship their span buffers and
    probe records back with each response — the handles below then cover
    the distributed path too, no extra plumbing.
    """

    trace: "Tracer | None" = None  # span tracer, active for every served batch
    metrics: "Registry | None" = None  # facade registry (engine creates one if None)
    probe_log: "ProbeLog | None" = None  # per-(query, term, shard) probe JSONL
    # rotate a file-backed probe log past this size (ProbeLog(max_bytes=));
    # None = unbounded (launch/serve.py threads --probe-log-max-bytes here)
    probe_log_max_bytes: int | None = None
    slo: "SLOMonitor | None" = None  # per-tenant SLO window (Session makes one if None)


@dataclass
class RankedConfig:
    """Ranked (BM25 top-k) tier knobs."""

    enabled: bool = True  # build payload streams when the index carries tfs
    payload_bits: int = 8  # quantized-impact width (BM25Params.bits)
    # queries whose total postings fit under this skip MaxScore bookkeeping
    # and score exhaustively (still exact); 0 forces pruning everywhere
    topk_exhaustive_cutoff: int = 2048
    score_kernel: bool = False  # score exhaustive queries on the bm25_score kernel
    # answer each shard's ranked batch with fused_topk launches (one per
    # candidate bucket) instead of the multi-phase probe/unpack/score/select
    # pipeline; bit-identical, with the multi-phase path as oracle
    fused_kernel: bool = False
    # keep a device-resident impact arena per shard (kernels.arena) so the
    # fused path answers no-required-term items with the dense loop; built
    # lazily on first fused use, only while the shard fits the size caps
    device_arena: bool = True

    def __bool__(self) -> bool:  # legacy truthiness: `if cfg.ranked:`
        return self.enabled


@dataclass
class SchedConfig:
    """Continuous-batching scheduler (serve/sched.Session) knobs."""

    max_batch: int = 16  # coalesce at most this many arrivals per dispatch
    max_queue: int = 256  # admission bound on queued requests
    # after the first arrival, wait up to this long for more to coalesce
    # (0 = dispatch whatever is queued the moment the scheduler is free)
    batch_window_us: int = 0
    # process replicas per shard; 0 = inline execution on the session's own
    # dispatch thread (the engine's ShardEngines, serial fan-out)
    n_replicas: int = 0
    default_deadline_ms: float | None = None  # applied when a request has none
    tenant_quota: int | None = None  # max queued requests per tenant
    worker_retries: int = 1  # batch retries after a worker crash
    spawn_timeout_s: float = 120.0  # process-replica ready handshake bound
    # bounded coalescing window, measured from the *head* arrival's submit
    # time: while a forming batch is below max_batch and its oldest entry
    # has waited less than this, take_batch lingers for more arrivals (adds
    # at most coalesce_us to any request's latency; a batch that already
    # waited while runners were busy dispatches immediately)
    coalesce_us: int = 0
    # forward the global running kth-score floor across shard-group ranked
    # dispatches: groups run in ascending-lo order and each later group
    # inherits the merged heap's kth score as its floor, so shards stop
    # scoring candidates the global top-k already excludes
    forward_floor: bool = True
    # replay each replica's recent call signatures after a respawn so the
    # fresh worker uploads its tables and launches every shape the crashed
    # one had served before it takes traffic
    warm_snapshot: bool = True
    # accepted for parity with the reference's compile-cache directory;
    # selects nothing (see the module doc)
    compile_cache_dir: str | None = None


# legacy flat kwarg -> (sub-config attr, field on it)
_LEGACY = {
    "trace": ("obs", "trace"),
    "metrics": ("obs", "metrics"),
    "probe_log": ("obs", "probe_log"),
    "payload_bits": ("ranked", "payload_bits"),
    "topk_exhaustive_cutoff": ("ranked", "topk_exhaustive_cutoff"),
    "score_kernel": ("ranked", "score_kernel"),
    "fused_kernel": ("ranked", "fused_kernel"),
}

# (filename, lineno, message) triples that already warned: the flat-kwarg
# shim fires once per *call site*, not on every sub-config rebuild — worker
# respawns and per-request reconstruction otherwise flood test output
_WARNED_SITES: set[tuple] = set()


def _warn_once(message: str, *, stacklevel: int) -> None:
    """DeprecationWarning deduped by the frame that called the constructor."""
    import sys

    fr = sys._getframe(stacklevel)
    site = (fr.f_code.co_filename, fr.f_lineno, message)
    if site in _WARNED_SITES:
        return
    _WARNED_SITES.add(site)
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel + 1)


def _coerce(cls, value):
    """Sub-config argument: an instance, a kwargs dict, or None (defaults)."""
    if value is None:
        return cls()
    if isinstance(value, dict):
        return cls(**value)
    return value


class ServeConfig:
    """Engine-core flags + the three nested sub-configs (see module doc)."""

    def __init__(
        self,
        algorithm: str = "block",
        verified: bool = True,
        use_kernel: bool = False,  # accepted for parity; see the module doc
        max_query_terms: int = 8,
        postings_store: str = "hybrid",  # tier-2: "hybrid" (compressed) | "raw"
        use_guided: bool = True,  # model-guided contains() probes
        guided_kernel: bool = False,  # accepted for parity; see the module doc
        cache_budget_bytes: int = 32 << 20,  # decode-cost budget per shard LRU
        n_shards: int = 1,  # document partitions (contiguous, 32-aligned)
        device: str = "cuda",  # where masks, probes, decodes and scoring run
        obs: ObsConfig | None = None,
        ranked: "RankedConfig | bool | None" = None,
        sched: SchedConfig | None = None,
        **legacy,
    ):
        self.algorithm = algorithm
        self.verified = verified
        self.use_kernel = use_kernel
        self.max_query_terms = max_query_terms
        self.postings_store = postings_store
        self.use_guided = use_guided
        self.guided_kernel = guided_kernel
        self.cache_budget_bytes = cache_budget_bytes
        self.n_shards = n_shards
        self.device = str(device)
        self.obs = _coerce(ObsConfig, obs)
        if isinstance(ranked, bool):  # old `ranked=False` bool flag
            legacy["ranked"] = ranked
            ranked = None
        self.ranked = _coerce(RankedConfig, ranked)
        if not isinstance(self.ranked, RankedConfig):
            raise TypeError(f"ranked must be a RankedConfig, a dict or a bool, got {ranked!r}")
        self.sched = _coerce(SchedConfig, sched)
        if legacy.pop("shard_workers", None) is not None:
            _warn_once(
                "ServeConfig(shard_workers=) is retired: the thread-pool "
                "fan-out is superseded by the serve.sched scheduler "
                "(ServeConfig.sched.n_replicas process replicas)",
                stacklevel=2,
            )
        unknown = set(legacy) - set(_LEGACY) - {"ranked"}
        if unknown:
            raise TypeError(f"unknown ServeConfig kwarg(s): {sorted(unknown)}")
        if legacy:
            _warn_once(
                f"flat ServeConfig kwarg(s) {sorted(legacy)} are deprecated; "
                "use the nested sub-configs (ServeConfig.obs / .ranked)",
                stacklevel=2,
            )
        for k, v in legacy.items():
            if k == "ranked":
                self.ranked.enabled = v
            else:
                sub, attr = _LEGACY[k]
                setattr(getattr(self, sub), attr, v)

    def __repr__(self) -> str:
        flags = ", ".join(
            f"{k}={getattr(self, k)!r}"
            for k in ("algorithm", "verified", "n_shards", "postings_store", "device")
        )
        return f"ServeConfig({flags}, obs={self.obs!r}, ranked={self.ranked!r}, sched={self.sched!r})"

    # ------------------------------------------------ flat-attribute compat
    # Old code reads/writes `cfg.trace`, `cfg.payload_bits`, ... — forward
    # silently (the deprecation surface is the constructor kwargs).
    @property
    def trace(self):
        return self.obs.trace

    @trace.setter
    def trace(self, v):
        self.obs.trace = v

    @property
    def metrics(self):
        return self.obs.metrics

    @metrics.setter
    def metrics(self, v):
        self.obs.metrics = v

    @property
    def probe_log(self):
        return self.obs.probe_log

    @probe_log.setter
    def probe_log(self, v):
        self.obs.probe_log = v

    @property
    def payload_bits(self) -> int:
        return self.ranked.payload_bits

    @payload_bits.setter
    def payload_bits(self, v: int):
        self.ranked.payload_bits = v

    @property
    def topk_exhaustive_cutoff(self) -> int:
        return self.ranked.topk_exhaustive_cutoff

    @topk_exhaustive_cutoff.setter
    def topk_exhaustive_cutoff(self, v: int):
        self.ranked.topk_exhaustive_cutoff = v

    @property
    def score_kernel(self) -> bool:
        return self.ranked.score_kernel

    @score_kernel.setter
    def score_kernel(self, v: bool):
        self.ranked.score_kernel = v

    @property
    def fused_kernel(self) -> bool:
        return self.ranked.fused_kernel

    @fused_kernel.setter
    def fused_kernel(self, v: bool):
        self.ranked.fused_kernel = v

    # ------------------------------------------------------- worker export
    def worker_spec(self) -> dict:
        """Picklable kwargs reconstructing this config in a worker process.

        Drops the obs handles (a worker builds its own registry; tracer and
        probe log are facade-side) and the sched block (workers execute, the
        session schedules).  Keeps ``device``: a worker serves where its
        parent's engine does.
        """
        return {
            "algorithm": self.algorithm,
            "verified": self.verified,
            "use_kernel": self.use_kernel,
            "max_query_terms": self.max_query_terms,
            "postings_store": self.postings_store,
            "use_guided": self.use_guided,
            "guided_kernel": self.guided_kernel,
            "cache_budget_bytes": self.cache_budget_bytes,
            "n_shards": self.n_shards,
            "device": self.device,
            "ranked": RankedConfig(
                enabled=self.ranked.enabled,
                payload_bits=self.ranked.payload_bits,
                topk_exhaustive_cutoff=self.ranked.topk_exhaustive_cutoff,
                score_kernel=self.ranked.score_kernel,
                fused_kernel=self.ranked.fused_kernel,
                device_arena=self.ranked.device_arena,
            ),
        }
