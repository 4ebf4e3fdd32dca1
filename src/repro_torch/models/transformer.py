"""The LM family: one decoder implementation covering all five assigned archs.

Features selected per ArchConfig:
  * GQA / MQA (phi4-mini, gemma, gemma2) or MLA (deepseek-v2-lite, -v3)
  * RoPE, SwiGLU / GeGLU, RMSNorm (gemma (1+scale) convention)
  * gemma2: local(window)+global alternation, attn & final logit softcaps,
    post-attention/post-ffn norms, embedding scale sqrt(d_model)
  * deepseek MoE: shared+routed experts, top-k, aux-loss-free bias, first
    k layers dense; dsv3 MTP head (one extra block predicting token t+2)

``LMModel`` holds the parameters under the reference's ``LMParams`` names:
``embed``, ``prefix`` (the dense-prefix blocks), ``stacked`` (the periodic
layers: one entry per layer where the reference stacks each of its
``period`` positions along a leading group axis — entry ``g * period + j``
is the reference's ``stacked[j][g]``), ``final_norm``, ``lm_head`` (None
when tied) and ``mtp``.  The forward functions are the reference's, on
tensors, with ``compute_dtype`` bf16 by default.  Activation checkpointing
("remat") wraps each block, never the whole loss.  Serving
(``lm_prefill``, ``lm_decode_step``) runs without gradients and writes the
caches in place.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn as tnn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.common import nn
from repro_torch.common.config import ArchConfig
from repro_torch.common.device import init_generator, resolve_device
from repro_torch.common.sharding import constrain, is_dtensor, mesh_size, take_last, take_rows
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.train.steps import _save_dots

Axes = tuple  # logical axis names of one parameter, one a dim


# ------------------------------------------------------------------ FFN
def init_ffn(gen, cfg: ArchConfig, dtype=torch.float32, device=None, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s = 1.0 / math.sqrt(d)
    kw = dict(dtype=dtype, device=device)
    params = {
        "w_gate": nn.normal_init(gen, (d, f), s, **kw),
        "w_up": nn.normal_init(gen, (d, f), s, **kw),
        "w_down": nn.normal_init(gen, (f, d), 1.0 / math.sqrt(f), **kw),
    }
    axes = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}
    return params, axes


def ffn(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    g = constrain(x @ params["w_gate"].to(dtype), "batch", None, "mlp")
    u = constrain(x @ params["w_up"].to(dtype), "batch", None, "mlp")
    act = nn.gelu(g) if cfg.activation == "geglu" else F.silu(g)
    return (act * u) @ params["w_down"].to(dtype)


# ------------------------------------------------------------------ block
def init_block(gen, cfg: ArchConfig, layer_idx: int, dtype=torch.float32, device=None):
    """One transformer block; layer_idx selects attn type + dense/moe ffn."""
    params: dict[str, Any] = {}
    axes: dict[str, Any] = {}
    if cfg.use_mla:
        params["attn"], axes["attn"] = attn.init_mla(gen, cfg, dtype, device)
    else:
        params["attn"], axes["attn"] = attn.init_gqa(gen, cfg, dtype, device)
    use_moe = cfg.use_moe and layer_idx >= cfg.first_dense_layers
    if use_moe:
        params["ffn"], axes["ffn"] = moe_mod.init_moe(gen, cfg, dtype, device)
    else:
        params["ffn"], axes["ffn"] = init_ffn(gen, cfg, dtype, device)
    norms = ["ln1", "ln2"]
    if cfg.name.startswith("gemma2"):  # post-norms (gemma2 only)
        norms += ["post_ln1", "post_ln2"]
    for n in norms:
        params[n] = nn.rmsnorm_init(cfg.d_model, dtype, device)
        axes[n] = {"scale": (None,)}
    return params, axes


def block_forward(
    params,
    cfg: ArchConfig,
    layer_idx: int,
    x: torch.Tensor,
    q_pos: torch.Tensor,
    cache: attn.KVCache | None = None,
) -> tuple[torch.Tensor, attn.KVCache | None]:
    a_type = cfg.attn_types[layer_idx % len(cfg.attn_types)]
    window = cfg.window_size if a_type == "local" else None
    x = constrain(x, "batch", None, None)
    h = nn.rmsnorm(params["ln1"], x, eps=cfg.norm_eps)
    if cfg.use_mla:
        a, new_cache = attn.mla_attention(params["attn"], cfg, h, q_pos, cache=cache)
    else:
        a, new_cache = attn.gqa_attention(params["attn"], cfg, h, q_pos, window=window, cache=cache)
    # each branch's output (a sum over the model axis) laid out as the
    # residual stream, its gradient too: else DTensor may scatter the sum
    # over the sequence, which the products of the backward then flatten
    a = constrain(a, "batch", None, None)
    if "post_ln1" in params:
        a = nn.rmsnorm(params["post_ln1"], a, eps=cfg.norm_eps)
    x = x + a
    h = nn.rmsnorm(params["ln2"], x, eps=cfg.norm_eps)
    use_moe = cfg.use_moe and layer_idx >= cfg.first_dense_layers
    f = moe_mod.moe_dispatch(params["ffn"], cfg, h) if use_moe else ffn(params["ffn"], cfg, h)
    f = constrain(f, "batch", None, None)
    if "post_ln2" in params:
        f = nn.rmsnorm(params["post_ln2"], f, eps=cfg.norm_eps)
    return x + f, new_cache


# ------------------------------------------------------------------ model
def _layer_split(cfg: ArchConfig) -> tuple[int, int, int]:
    """(n_prefix, n_scan_groups, period)."""
    period = len(cfg.attn_types)
    n_prefix = cfg.first_dense_layers if cfg.use_moe else 0
    rest = cfg.n_layers - n_prefix
    assert rest % period == 0, (cfg.n_layers, n_prefix, period)
    return n_prefix, rest // period, period


class LMModel(tnn.Module):
    """The reference's ``LMParams`` as a module (see the module docstring)."""

    def __init__(self, cfg: ArchConfig, embed: Mapping, prefix: Sequence[Mapping],
                 stacked: Sequence[Mapping], final_norm: Mapping, lm_head: Mapping | None = None,
                 mtp: Mapping | None = None):
        super().__init__()
        n_prefix, n_groups, period = _layer_split(cfg)
        if len(prefix) != n_prefix or len(stacked) != n_groups * period:
            raise ValueError(f"{len(prefix)} prefix and {len(stacked)} stacked blocks for "
                             f"{cfg.name}'s {n_prefix} and {n_groups} x {period}")
        self.cfg = cfg
        self.embed = nn.ParamTree(embed)
        self.prefix = tnn.ModuleList(nn.ParamTree(p) for p in prefix)
        self.stacked = tnn.ModuleList(nn.ParamTree(p) for p in stacked)
        self.final_norm = nn.ParamTree(final_norm)
        self.lm_head = nn.ParamTree(lm_head) if lm_head is not None else None
        self.mtp = nn.ParamTree(mtp) if mtp is not None else None

    def blocks(self) -> list[tuple[int, nn.ParamTree]]:
        """(layer_idx as block_forward takes it, block) in layer order."""
        n_prefix, _, period = _layer_split(self.cfg)
        return list(enumerate(self.prefix)) + [
            (n_prefix + i % period, bp) for i, bp in enumerate(self.stacked)]


def init_lm(seed: int | torch.Generator, cfg: ArchConfig, dtype=torch.float32, *,
            device: str | torch.device = "cuda") -> tuple[LMModel, dict[str, Axes]]:
    """-> (model, {state-dict name: logical axes}).  The reference's
    distributions and scales, drawn from a generator on ``device``; on
    ``torch.device("meta")`` shapes and dtypes only, allocation-free at any
    scale (the counterpart of ``jax.eval_shape``)."""
    gen, dev = init_generator(seed, device)
    n_prefix, n_groups, period = _layer_split(cfg)
    kw = dict(dtype=dtype, device=dev)
    embed = {"table": nn.normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02, **kw)}
    axes: dict[str, Axes] = {"embed.table": ("vocab", None)}

    prefix = []
    for i in range(n_prefix):
        p, a = init_block(gen, cfg, i, **kw)
        prefix.append(p)
        nn.flat_axes(a, f"prefix.{i}", axes)
    stacked = []
    for g in range(n_groups):
        for j in range(period):
            p, a = init_block(gen, cfg, n_prefix + j, **kw)
            stacked.append(p)
            nn.flat_axes(a, f"stacked.{g * period + j}", axes)
    final_norm = nn.rmsnorm_init(cfg.d_model, **kw)
    axes["final_norm.scale"] = (None,)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = {"w": nn.normal_init(gen, (cfg.d_model, cfg.vocab_size),
                                       1.0 / math.sqrt(cfg.d_model), **kw)}
        axes["lm_head.w"] = (None, "vocab")
    mtp = None
    if cfg.use_mtp:
        mtp, a = init_block(gen, cfg, cfg.n_layers - 1, **kw)
        nn.flat_axes(a, "mtp", axes)
    return LMModel(cfg, embed, prefix, stacked, final_norm, lm_head, mtp), axes


def _tree_index(tree: Any, g: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _tree_index(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]


def lm_params_from_jax(params_np: Any, cfg: ArchConfig, *, device: str | torch.device = "cuda"
                       ) -> LMModel:
    """The reference's ``LMParams`` (arrays as numpy, or anything
    ``np.asarray`` reads) as an ``LMModel``: ``stacked`` is unstacked along
    its group axis, period by period, into one entry per layer."""
    dev = resolve_device(device)
    embed, prefix, stacked, final_norm, lm_head, mtp = params_np
    _, n_groups, period = _layer_split(cfg)
    layers = [_tree_index(stacked[j], g) for g in range(n_groups) for j in range(period)]
    conv = partial(nn.tree_to_torch, device=dev)
    return LMModel(cfg, conv(embed), [conv(p) for p in prefix], [conv(p) for p in layers],
                   conv(final_norm), conv(lm_head), conv(mtp))


def _maybe_remat(fn, remat: str):
    """Per-BLOCK activation checkpointing: 'none' keeps every activation,
    'dots' keeps the 2-D products' outputs (the reference's
    checkpoint_dots_with_no_batch_dims) and recomputes the rest, 'full'
    keeps only the block's input."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    if remat == "dots":
        ctx = partial(create_selective_checkpoint_contexts, _save_dots)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False, context_fn=ctx)
    if remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    raise ValueError(f"unknown remat policy {remat}")


def _run_blocks(model: LMModel, cfg: ArchConfig, x, q_pos, caches=None, remat: str = "none"):
    """Every block in layer order -> (x, per-layer caches or None)."""
    new_caches: list[Any] = []
    for li, (layer_idx, bp) in enumerate(model.blocks()):
        if caches is None:
            fn = _maybe_remat(
                lambda x, bp=bp, layer_idx=layer_idx: block_forward(bp, cfg, layer_idx, x, q_pos)[0],
                remat)
            x = fn(x)
        else:
            x, nc = block_forward(bp, cfg, layer_idx, x, q_pos, caches[li])
            new_caches.append(nc)
    return x, (new_caches if caches is not None else None)


def _embed_in(model: LMModel, cfg: ArchConfig, tokens: torch.Tensor, compute_dtype,
              scale: bool = True) -> torch.Tensor:
    # rows gathered, then cast: the values of the reference's cast-then-take
    table = model.embed["table"]
    x = take_rows(table, tokens.long()).to(compute_dtype)
    if scale and cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype, device=x.device)
    return x


def _head(model: LMModel, cfg: ArchConfig, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    x = constrain(x, "batch", *(None,) * (x.dim() - 1))  # its gradient laid out so too
    if model.lm_head is None:
        logits = x @ model.embed["table"].to(compute_dtype).T
    else:
        logits = x @ model.lm_head["w"].to(compute_dtype)
    # laid out by batch and vocab, its gradient too (DTensor may move the
    # cross entropy's vocab reduction onto the sequence)
    logits = constrain(logits, "batch", None, "vocab")
    return nn.softcap(logits.float(), cfg.logit_softcap)


def lm_logits(model: LMModel, cfg: ArchConfig, tokens: torch.Tensor,
              compute_dtype=torch.bfloat16, remat: str = "none") -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) fp32. Training/prefill path (no cache)."""
    x = _embed_in(model, cfg, tokens, compute_dtype)
    s = tokens.shape[1]
    # row-shared positions: (1,S) keeps the causal mask batch-free (1,1,S,S)
    q_pos = torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :]
    x, _ = _run_blocks(model, cfg, x, q_pos, remat=remat)
    x = nn.rmsnorm(model.final_norm, x, eps=cfg.norm_eps)
    return _head(model, cfg, x, compute_dtype)


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    # CE via logsumexp: no second (B,S,V) log-softmax buffer; (B, S, 1)
    # throughout
    if not is_dtensor(logits) or mesh_size(logits.device_mesh) <= 1:
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        return (lse - logits.gather(-1, labels[..., None].long())).mean()
    # on a mesh each rank reduces and picks from its own vocab block (DTensor's
    # logsumexp and gather would gather the vocab whole): the max and the sum
    # of exponentials reduce over the ranks, the picked logit is partial
    top = logits.detach().amax(dim=-1, keepdim=True)
    lse = top + torch.log(torch.exp(logits - top).sum(dim=-1, keepdim=True))
    return (lse - take_last(logits, labels)).mean()


def lm_loss(model: LMModel, cfg: ArchConfig, batch: Mapping[str, torch.Tensor],
            compute_dtype=torch.bfloat16, remat: str = "none") -> torch.Tensor:
    logits = lm_logits(model, cfg, batch["tokens"], compute_dtype, remat=remat)
    labels = batch["labels"]
    loss = _cross_entropy(logits, labels)
    if cfg.use_mtp and model.mtp is not None:
        # MTP: predict t+2 from the embeddings through one extra block
        # (dsv3 §2.2, single-depth variant). Shares embed/head.
        x = _embed_in(model, cfg, batch["tokens"], compute_dtype, scale=False)
        s = batch["tokens"].shape[1]
        q_pos = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
        h, _ = block_forward(model.mtp, cfg, cfg.n_layers - 1, x, q_pos)
        h = nn.rmsnorm(model.final_norm, h, eps=cfg.norm_eps)
        mtp_logits = _head(model, cfg, h, compute_dtype)
        # labels shifted one extra step
        loss = loss + 0.3 * _cross_entropy(mtp_logits[:, :-1], labels[:, 1:])
    return loss


# ------------------------------------------------------------------ serving
def cache_spec(cfg: ArchConfig, batch: int, max_len: int) -> list[tuple[tuple, tuple]]:
    """(k shape, v shape) of every layer's cache, in layer order (the
    reference's stacked groups as one entry per layer)."""
    n_prefix, n_groups, period = _layer_split(cfg)

    def one(layer_idx):
        a_type = cfg.attn_types[layer_idx % len(cfg.attn_types)]
        s_cache = min(max_len, cfg.window_size) if a_type == "local" else max_len
        if cfg.use_mla:
            return (batch, s_cache, cfg.kv_lora_rank), (batch, s_cache, cfg.qk_rope_head_dim)
        hd = cfg.resolved_head_dim
        return (batch, s_cache, cfg.n_kv_heads, hd), (batch, s_cache, cfg.n_kv_heads, hd)

    return [one(i) for i in range(n_prefix)] + [
        one(n_prefix + j) for _ in range(n_groups) for j in range(period)]


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device: str | torch.device = "cuda") -> list[attn.KVCache]:
    dev = torch.device(device)
    dev = dev if dev.type == "meta" else resolve_device(dev)
    return [attn.KVCache(torch.zeros(k, dtype=dtype, device=dev), torch.zeros(v, dtype=dtype, device=dev))
            for k, v in cache_spec(cfg, batch, max_len)]


@torch.no_grad()
def lm_decode_step(
    model: LMModel,
    cfg: ArchConfig,
    token: torch.Tensor,  # (B, 1) int32
    pos: torch.Tensor,  # (B, 1) int32 absolute position of `token`
    caches: list[attn.KVCache],
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, list[attn.KVCache]]:
    """One serving step: new token + caches -> (logits (B, V), caches)."""
    x = _embed_in(model, cfg, token, compute_dtype)
    x, new_caches = _run_blocks(model, cfg, x, pos, caches)
    x = nn.rmsnorm(model.final_norm, x, eps=cfg.norm_eps)
    return _head(model, cfg, x[:, 0], compute_dtype), new_caches


@torch.no_grad()
def lm_prefill(
    model: LMModel,
    cfg: ArchConfig,
    tokens: torch.Tensor,  # (B, S)
    caches: list[attn.KVCache],
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, list[attn.KVCache]]:
    """Prefill: run the full prompt, writing caches; returns last-pos logits."""
    x = _embed_in(model, cfg, tokens, compute_dtype)
    b, s = tokens.shape
    q_pos = torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :].expand(b, s)
    x, new_caches = _run_blocks(model, cfg, x, q_pos, caches)
    x = nn.rmsnorm(model.final_norm, x, eps=cfg.norm_eps)
    return _head(model, cfg, x[:, -1], compute_dtype), new_caches
