"""Typed, frozen configs for every subsystem of the port: the reference's
config system, field for field.  Plain data, no torch, so a config can be
built before anything touches a device."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping


def _freeze(obj: Any) -> Any:
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


@dataclass(frozen=True)
class MeshConfig:
    """Production mesh description.

    axis order is (pod?, data, model). ``pod`` only exists multi-pod.
    """

    shape: tuple[int, ...] = (16, 16)
    axes: tuple[str, ...] = ("data", "model")

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_axes(self) -> tuple[str, ...]:
        """Axes used for data parallelism (pod folds into data)."""
        return tuple(a for a in self.axes if a in ("pod", "data"))


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    # 'fp32' | 'int8' — int8 moments with per-256-element fp32 absmax scales
    moment_dtype: str = "fp32"
    compress_grads: bool = False  # accepted for parity; single-device here


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    microbatch: int | None = None  # grad accumulation if < global_batch/dp
    remat: str = "none"  # 'none' | 'full' | 'dots' (checkpoint policy)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    seed: int = 0
    # straggler mitigation: abort+log if a step exceeds this multiple of the
    # trailing median step time
    straggler_factor: float = 3.0


@dataclass(frozen=True)
class ArchConfig:
    """Superset config covering all assigned architecture families.

    family ∈ {'lm', 'gnn', 'recsys'}; unused fields stay at defaults.
    """

    name: str = "unnamed"
    family: str = "lm"

    # --- LM transformer ---
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int | None = None  # default d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    activation: str = "swiglu"  # 'swiglu' | 'geglu' | 'gelu'
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # gemma-2 style
    attn_types: tuple[str, ...] = ("global",)  # cycled over layers
    window_size: int = 4096
    logit_softcap: float | None = None
    attn_softcap: float | None = None
    # 'heads' shards attention over the head axis; 'seq' shards over the query
    # sequence axis (SP) — for head counts indivisible by the model axis
    attn_shard: str = "heads"
    # MLA (deepseek)
    use_mla: bool = False
    q_lora_rank: int | None = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # MoE
    use_moe: bool = False
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 1  # deepseek: first k layers dense
    moe_aux_free: bool = True  # bias-based aux-loss-free balancing (dsv3)
    moe_capacity_factor: float = 1.25  # GShard capacity; large => dropless
    moe_a2a: bool = False  # explicit all-to-all dispatch (expert parallelism)
    # MTP (dsv3) — extra next-next-token prediction head
    use_mtp: bool = False
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d_model)

    # --- GNN ---
    gnn_layers: int = 15
    gnn_hidden: int = 128
    gnn_mlp_layers: int = 2
    gnn_aggregator: str = "sum"
    node_feat_dim: int = 128
    edge_feat_dim: int = 4
    gnn_out_dim: int = 2

    # --- RecSys ---
    n_dense: int = 0
    n_sparse: int = 26
    embed_dim: int = 128
    vocab_sizes: tuple[int, ...] = ()
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
    interaction: str = "dot"  # 'dot' | 'fm-2way' | 'transformer-seq' | 'multi-interest'
    hist_len: int = 20  # BST behaviour-sequence length
    n_blocks: int = 1
    n_interests: int = 4
    capsule_iters: int = 3

    def replace(self, **kw: Any) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads


@dataclass(frozen=True)
class LearnedIndexConfig:
    """Config for the paper's contribution (core/)."""

    algorithm: str = "two_tier"  # 'exhaustive' | 'two_tier' | 'block'
    embed_dim: int = 128  # paper's s=512bit worst case = 128 fp32 units
    mlp_hidden: tuple[int, ...] = ()  # () = pure dot-product model
    truncation_k: int = 4000  # two-tier tier-1 list length
    block_size: int = 1024  # block-based approach: docs per block
    replace_df_threshold: int = 4000  # terms with df>k get replaced by f
    guarantee: bool = True  # zero-FN threshold + exact backup set
    threshold: float = 0.5
    train_negatives_per_positive: int = 4
    model_bits_per_pair: float = 512.0  # 's' in Eq.(2), upper bound


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell from the assignment (arch × shape grid)."""

    name: str = "train_4k"
    kind: str = "train"  # 'train' | 'prefill' | 'decode' | 'retrieval' | 'serve'
    seq_len: int = 4096
    global_batch: int = 256
    # gnn
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple[int, ...] = ()
    n_graphs: int = 0
    # recsys
    n_candidates: int = 0

    def replace(self, **kw: Any) -> "ShapeSpec":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class CorpusConfig:
    """Synthetic Zipf-Mandelbrot collection calibrated to a TREC target."""

    name: str = "robust-like"
    n_docs: int = 5280  # Robust05 |D|=528k scaled 1/100
    n_terms: int = 60_000
    avg_doc_len: int = 230
    zipf_a: float = 1.2
    zipf_b: float = 2.7
    seed: int = 7


PAPER_COLLECTIONS: Mapping[str, CorpusConfig] = {
    # scaled 1/100 from published sizes; scale=1.0 reproduces full scale
    "robust": CorpusConfig(name="robust-like", n_docs=5280, n_terms=60_000, avg_doc_len=230),
    "gov2": CorpusConfig(name="gov2-like", n_docs=252_000, n_terms=390_000, avg_doc_len=410),
    "clueweb": CorpusConfig(name="clueweb-like", n_docs=502_000, n_terms=960_000, avg_doc_len=380),
}


def scaled_collection(base: CorpusConfig, scale: float) -> CorpusConfig:
    return dataclasses.replace(
        base,
        n_docs=max(64, int(base.n_docs * scale)),
        n_terms=max(256, int(base.n_terms * scale)),
    )
