"""Cell factory: (ArchConfig × ShapeSpec) -> step fn + input specs + axes.

The one place the launchers, ``chip_smoke.py`` and the tests resolve a cell
of the arch × shape grid.  A cell bundle holds:
  step          — the step: train (model, opt_state, batch) -> metrics,
                  prefill (model, tokens) -> (logits, caches), decode
                  (model, token, pos, caches) -> (logits, caches)
  init_fn       — (seed, device) -> model (real tensors)
  param_specs   — {state-dict name: TensorSpec}, from the model built on the
                  meta device (the counterpart of ``jax.eval_shape``):
                  shapes and dtypes at full scale without allocating
  param_axes    — {state-dict name: logical axes}
  input_specs   — TensorSpecs of the data inputs (decode: of the caches too)
  input_axes    — logical axes for the data inputs
  kind          — train | prefill | decode

Axes come from the real init on a structure-preserving SKELETON config (tiny
dims, the same layer/table/feature structure): axes depend only on
structure, never on dims.  This slice ports the LM family; the GNN and
recsys cells come with their models in the next slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.common.config import ArchConfig, OptimizerConfig, ShapeSpec, TrainConfig
from repro_torch.models import transformer as tf_mod
from repro_torch.models.attention import KVCache
from repro_torch.train import make_train_step


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


def lm_cell(cfg: ArchConfig, shape: ShapeSpec, *, remat: str = "dots") -> CellBundle:
    pdtype = _lm_param_dtype(cfg)

    def init_fn(seed: int = 0, device: str | torch.device = "cuda") -> tf_mod.LMModel:
        return tf_mod.init_lm(seed, cfg, pdtype, device=device)[0]

    axes = tf_mod.init_lm(0, skeleton(cfg), pdtype, device="meta")[1]
    meta = tf_mod.init_lm(0, cfg, pdtype, device="meta")[0]
    param_specs = {n: _sds(p.shape, p.dtype) for n, p in meta.named_parameters()}
    del meta

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
            caches = tf_mod.init_cache(cfg, b, s, torch.bfloat16, device=tokens.device)
            return tf_mod.lm_prefill(model, cfg, tokens, caches)

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


# ===================================================================== entry
def build_cell(cfg: ArchConfig, shape: ShapeSpec, **kw) -> CellBundle:
    if cfg.family == "lm":
        return lm_cell(cfg, shape, **kw)
    if cfg.family in ("gnn", "recsys"):
        raise NotImplementedError(
            f"{cfg.family} cells ({cfg.name}) come with models/gnn.py, models/recsys.py and "
            "models/sampler.py in the next slice of the port")
    raise ValueError(cfg.family)
