"""Cell factory: (ArchConfig × ShapeSpec) -> step fn + input specs + axes.

The one place the launchers, ``chip_smoke.py`` and the tests resolve a cell
of the arch × shape grid.  A cell bundle holds:
  step          — the step: train (model, opt_state, batch) -> metrics,
                  prefill (model, tokens) -> (logits, caches), decode
                  (model, token, pos, caches) -> (logits, caches), serve
                  (model, batch) -> scores, retrieval (model, batch) ->
                  (top-100 scores, their candidate positions)
  init_fn       — (seed, device) -> model (real tensors)
  param_specs   — {state-dict name: TensorSpec}, from the model built on the
                  meta device (the counterpart of ``jax.eval_shape``):
                  shapes and dtypes at full scale without allocating
  param_axes    — {state-dict name: logical axes}
  input_specs   — TensorSpecs of the data inputs (decode: of the caches too)
  input_axes    — logical axes for the data inputs
  kind          — train | prefill | decode | serve | retrieval

Axes come from the real init on a structure-preserving SKELETON config (tiny
dims, the same layer/table/feature structure): axes depend only on
structure, never on dims.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.common.config import ArchConfig, OptimizerConfig, ShapeSpec, TrainConfig
from repro_torch.common.sharding import constrain, is_dtensor, sharding_for_shape
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as rec_mod
from repro_torch.models import sampler as sampler_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.moe import top_k_lowest_index
from repro_torch.train import make_train_step

# per-shape feature dims where the assignment leaves them open (documented)
MINIBATCH_D_FEAT = 602  # Reddit-scale node features
MOLECULE_D_FEAT = 32


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor that is not allocated."""

    shape: tuple[int, ...]
    dtype: torch.dtype


@dataclass
class CellBundle:
    arch: ArchConfig
    shape: ShapeSpec
    kind: str
    step: Callable
    init_fn: Callable  # (seed, device) -> model
    param_specs: Any
    param_axes: Any
    input_specs: Any
    input_axes: Any
    opt_cfg: OptimizerConfig | None = None


def _sds(shape, dtype) -> TensorSpec:
    return TensorSpec(tuple(int(s) for s in shape), dtype)


def skeleton(cfg: ArchConfig) -> ArchConfig:
    """Structure-preserving tiny config (same parameter structure, tiny dims)."""
    kw: dict = {}
    if cfg.family == "lm":
        kw = dict(d_model=16, n_heads=2, n_kv_heads=min(cfg.n_kv_heads, 2),
                  head_dim=8, d_ff=16, vocab_size=32)
        if cfg.use_mla:
            kw.update(kv_lora_rank=8, qk_nope_head_dim=8, qk_rope_head_dim=4,
                      v_head_dim=8, q_lora_rank=8 if cfg.q_lora_rank else None)
        if cfg.use_moe:
            kw.update(n_routed_experts=max(2, min(cfg.n_routed_experts, 4)),
                      top_k=min(cfg.top_k, 2), moe_d_ff=8)
    elif cfg.family == "gnn":
        kw = dict(gnn_hidden=8, node_feat_dim=4, edge_feat_dim=cfg.edge_feat_dim,
                  gnn_out_dim=cfg.gnn_out_dim)
    elif cfg.family == "recsys":
        kw = dict(vocab_sizes=tuple(8 for _ in cfg.vocab_sizes), embed_dim=4,
                  bot_mlp=tuple(8 for _ in cfg.bot_mlp),
                  top_mlp=tuple(8 for _ in cfg.top_mlp[:-1]) + cfg.top_mlp[-1:]
                  if cfg.top_mlp else cfg.top_mlp)
    return dataclasses.replace(cfg, **kw)


def _specs_of(init, cfg: ArchConfig) -> tuple[dict[str, TensorSpec], dict]:
    """(param_specs from the model on the meta device, param_axes from the
    skeleton's); the two models' state-dict names match one for one."""
    meta = init(0, cfg, device="meta")[0]
    specs = {n: _sds(p.shape, p.dtype) for n, p in meta.named_parameters()}
    axes = init(0, skeleton(cfg), device="meta")[1]
    if set(specs) != set(axes):
        raise AssertionError(f"{cfg.name}: parameter and axes names differ")
    return specs, axes


# ===================================================================== LM
def _lm_param_dtype(cfg: ArchConfig) -> torch.dtype:
    # 671B-scale params train in bf16 (+int8 moments)
    return torch.bfloat16 if cfg.name.startswith("deepseek-v3") else torch.float32


def _lm_opt_cfg(cfg: ArchConfig) -> OptimizerConfig:
    return OptimizerConfig(
        moment_dtype="int8" if cfg.name.startswith("deepseek-v3") else "fp32"
    )


def _cache_axes(cfg: ArchConfig, cache_struct) -> list[KVCache]:
    """Logical axes of init_cache's per-layer caches: batch over data and
    the sequence axis over model (sequence parallelism for long caches)."""
    def one(leaf):
        return ("batch", "seq_sharded") + (None,) * (len(leaf.shape) - 2)

    return [KVCache(one(kv.k), one(kv.v)) for kv in cache_struct]


def _new_caches(cfg: ArchConfig, b: int, s: int, tokens: torch.Tensor) -> list[KVCache]:
    """Prefill's empty bf16 caches; on a mesh (DTensor tokens) DTensors laid
    out by ``_cache_axes``, each rank allocating its own block only."""
    if not is_dtensor(tokens):
        return tf_mod.init_cache(cfg, b, s, torch.bfloat16, device=tokens.device)
    from torch.distributed.tensor import zeros

    mesh = tokens.device_mesh
    struct = [KVCache(_sds(k, torch.bfloat16), _sds(v, torch.bfloat16))
              for k, v in tf_mod.cache_spec(cfg, b, s)]
    return [KVCache(*(zeros(t.shape, dtype=t.dtype, device_mesh=mesh,
                            placements=sharding_for_shape(ax, t.shape, mesh))
                      for t, ax in zip(kv, axes)))
            for kv, axes in zip(struct, _cache_axes(cfg, struct))]


def lm_cell(cfg: ArchConfig, shape: ShapeSpec, *, remat: str = "dots") -> CellBundle:
    pdtype = _lm_param_dtype(cfg)

    def init_fn(seed: int = 0, device: str | torch.device = "cuda") -> tf_mod.LMModel:
        return tf_mod.init_lm(seed, cfg, pdtype, device=device)[0]

    param_specs, axes = _specs_of(partial(tf_mod.init_lm, dtype=pdtype), cfg)

    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        # remat is applied per block inside the model (see _maybe_remat)
        def loss_fn(model, batch):
            return tf_mod.lm_loss(model, cfg, batch, remat=remat)

        opt_cfg = _lm_opt_cfg(cfg)
        train_step = make_train_step(loss_fn, opt_cfg, TrainConfig(remat="none"))
        inputs = {"tokens": _sds((b, s), torch.int32), "labels": _sds((b, s), torch.int32)}
        in_axes = {"tokens": ("batch", None), "labels": ("batch", None)}
        return CellBundle(cfg, shape, "train", train_step, init_fn, param_specs, axes,
                          inputs, in_axes, opt_cfg=opt_cfg)

    if shape.kind == "prefill":
        def step(model, tokens):
            return tf_mod.lm_prefill(model, cfg, tokens, _new_caches(cfg, b, s, tokens))

        inputs = {"tokens": _sds((b, s), torch.int32)}
        return CellBundle(cfg, shape, "prefill", step, init_fn, param_specs, axes,
                          inputs, {"tokens": ("batch", None)})

    # decode: one new token against a seq_len-deep cache
    cache_struct = [KVCache(_sds(k, torch.bfloat16), _sds(v, torch.bfloat16))
                    for k, v in tf_mod.cache_spec(cfg, b, s)]

    def step(model, token, pos, caches):
        return tf_mod.lm_decode_step(model, cfg, token, pos, caches)

    inputs = {
        "token": _sds((b, 1), torch.int32),
        "pos": _sds((b, 1), torch.int32),
        "caches": cache_struct,
    }
    in_axes = {
        "token": ("batch", None),
        "pos": ("batch", None),
        "caches": _cache_axes(cfg, cache_struct),
    }
    return CellBundle(cfg, shape, "decode", step, init_fn, param_specs, axes, inputs, in_axes)


# ===================================================================== GNN
GNN_PAD = 512  # node/edge counts padded to a multiple of every mesh size


def _pad_up(n: int, m: int = GNN_PAD) -> int:
    return -(-n // m) * m


def gnn_graph_dims(shape: ShapeSpec) -> tuple[int, int, int]:
    """(n_nodes, n_edges, d_feat) after padding/flattening rules."""
    if shape.name == "minibatch_lg":
        n, e = sampler_mod.subgraph_budget(shape.batch_nodes, shape.fanout)
        return _pad_up(n), _pad_up(e), MINIBATCH_D_FEAT
    if shape.name == "molecule":
        return (
            _pad_up(shape.n_nodes * shape.n_graphs),
            _pad_up(shape.n_edges * shape.n_graphs),
            MOLECULE_D_FEAT,
        )
    return _pad_up(shape.n_nodes), _pad_up(shape.n_edges), shape.d_feat


def gnn_cell(cfg: ArchConfig, shape: ShapeSpec) -> CellBundle:
    n, e, d_feat = gnn_graph_dims(shape)
    cfg = cfg.replace(node_feat_dim=d_feat)

    def init_fn(seed: int = 0, device: str | torch.device = "cuda"):
        return gnn_mod.init_mgn(seed, cfg, device=device)[0]

    param_specs, axes = _specs_of(gnn_mod.init_mgn, cfg)
    big = n > 500_000  # full-batch giants get per-layer remat

    def loss_fn(model, batch):
        return gnn_mod.mgn_loss(model, cfg, batch, remat=big)

    train_step = make_train_step(loss_fn, OptimizerConfig())
    inputs = {
        "node_feat": _sds((n, d_feat), torch.float32),
        "edge_feat": _sds((e, cfg.edge_feat_dim), torch.float32),
        "senders": _sds((e,), torch.int32),
        "receivers": _sds((e,), torch.int32),
        "node_mask": _sds((n,), torch.float32),
        "edge_mask": _sds((e,), torch.float32),
        "node_targets": _sds((n, cfg.gnn_out_dim), torch.float32),
    }
    # small graphs shard over data only below ~1M edges
    nd, ed = ("nodes", "edges") if e >= 1_000_000 else ("nodes_sm", "edges_sm")
    in_axes = {
        "node_feat": (nd, None),
        "edge_feat": (ed, None),
        "senders": (ed,),
        "receivers": (ed,),
        "node_mask": (nd,),
        "edge_mask": (ed,),
        "node_targets": (nd, None),
    }
    return CellBundle(cfg, shape, "train", train_step, init_fn, param_specs, axes,
                      inputs, in_axes, opt_cfg=OptimizerConfig())


# ===================================================================== RecSys
def recsys_batch_specs(cfg: ArchConfig, b: int) -> tuple[dict, dict]:
    if cfg.name == "dlrm-mlperf":
        sp = {
            "dense": _sds((b, cfg.n_dense), torch.float32),
            "sparse": _sds((b, cfg.n_sparse), torch.int32),
            "label": _sds((b,), torch.float32),
        }
        ax = {"dense": ("batch", None), "sparse": ("batch", None), "label": ("batch",)}
    elif cfg.name == "fm":
        sp = {"sparse": _sds((b, cfg.n_sparse), torch.int32), "label": _sds((b,), torch.float32)}
        ax = {"sparse": ("batch", None), "label": ("batch",)}
    else:  # bst, mind
        sp = {
            "hist": _sds((b, cfg.hist_len), torch.int32),
            "target": _sds((b,), torch.int32),
            "label": _sds((b,), torch.float32),
        }
        ax = {"hist": ("batch", None), "target": ("batch",), "label": ("batch",)}
    return sp, ax


def recsys_cell(cfg: ArchConfig, shape: ShapeSpec) -> CellBundle:
    init = rec_mod.INIT[cfg.name]

    def init_fn(seed: int = 0, device: str | torch.device = "cuda"):
        return init(seed, cfg, device=device)[0]

    param_specs, axes = _specs_of(init, cfg)
    b = shape.global_batch

    if shape.kind == "train":
        def loss_fn(model, batch):
            return rec_mod.recsys_loss(model, cfg, batch)

        train_step = make_train_step(loss_fn, OptimizerConfig())
        sp, ax = recsys_batch_specs(cfg, b)
        return CellBundle(cfg, shape, "train", train_step, init_fn, param_specs, axes,
                          sp, ax, opt_cfg=OptimizerConfig())

    if shape.kind == "serve":
        sp, ax = recsys_batch_specs(cfg, b)
        sp.pop("label"); ax.pop("label")

        @torch.no_grad()
        def step(model, batch):
            return rec_mod.FORWARD[cfg.name](model, cfg, batch)

        return CellBundle(cfg, shape, "serve", step, init_fn, param_specs, axes, sp, ax)

    # retrieval: one user context x n_candidates, return top-100
    sp, ax = recsys_batch_specs(cfg, max(1, b))
    for k in ("label", "target"):
        sp.pop(k, None); ax.pop(k, None)
    sp["candidates"] = _sds((shape.n_candidates,), torch.int32)
    ax["candidates"] = ("candidates",)

    @torch.no_grad()
    def step(model, batch):
        cand = batch["candidates"]
        rest = {k: v for k, v in batch.items() if k != "candidates"}
        scores = rec_mod.RETRIEVAL[cfg.name](model, cfg, rest, cand)
        # on a mesh each rank's candidates' scores, gathered (C fp32) before the sort
        scores = constrain(scores, None)
        return top_k_lowest_index(scores, 100)  # lax.top_k: ties to the lower index

    return CellBundle(cfg, shape, "retrieval", step, init_fn, param_specs, axes, sp, ax)


# ===================================================================== entry
def build_cell(cfg: ArchConfig, shape: ShapeSpec, **kw) -> CellBundle:
    if cfg.family == "lm":
        return lm_cell(cfg, shape, **kw)
    if cfg.family == "gnn":
        return gnn_cell(cfg, shape)
    if cfg.family == "recsys":
        return recsys_cell(cfg, shape)
    raise ValueError(cfg.family)
