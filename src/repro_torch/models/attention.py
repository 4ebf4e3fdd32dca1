"""Attention variants for the LM family: GQA/MQA, sliding-window, softcap, MLA.

Functions over parameter mappings (a dict of tensors, or a module indexed
like one).  Shapes follow (B, S, H, hd), with GQA as a head-group product
(no kv repeat).  All masks are additive fp32 biases computed from position
indices, so the same code serves training (full causal), prefill and
single-token decode against a cache.

The reference's arithmetic, op for op: the projections are plain products
in the compute dtype; the score products take fp32 operands (the
reference's ``preferred_element_type=float32`` on bf16 operands: a torch
bf16 product would round its output to bf16), then softcap, mask add,
softmax, and the value product back in the compute dtype.  No fused
attention: ``scaled_dot_product_attention`` would change that arithmetic.

Caches are written in place: ``gqa_attention`` and ``mla_attention`` write
the new rows into the cache they are given and return it.
"""
from __future__ import annotations

import math
from typing import Any, Mapping, NamedTuple

import torch

from repro_torch.common import nn
from repro_torch.common.config import ArchConfig
from repro_torch.common.sharding import (axis_size, constrain, is_dtensor, local_blocks, pin,
                                         spec_for_shape)

NEG_INF = -2.0e38

Params = Mapping[str, Any]


# ------------------------------------------------------------------ RoPE
def rope_freqs(dim: int, theta: float, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions[..., None].float() * inv  # (..., S, dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd) — rotate pairs (x[..., ::2], x[..., 1::2])."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ------------------------------------------------------------------ masks
def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int | None = None) -> torch.Tensor:
    """(B?, Sq) x (B?, Sk) position ids -> (.., Sq, Sk) additive mask.

    Negative k positions are always masked (ring-buffer slots not yet
    written report pos < 0 — see _ring_positions).
    """
    k, q = k_pos[..., None, :], q_pos[..., :, None]
    ok = (k <= q) & (k >= 0)
    if window is not None:
        ok &= k > (q - window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full((), NEG_INF, dtype=torch.float32, device=ok.device))


# ------------------------------------------------------------------ products
def _flat(y: torch.Tensor) -> torch.Tensor:
    """``y`` (B, ...) sharded over the batch only, so that a view can split
    its head dimension (a DTensor view cannot split a dimension sharded
    unevenly over the group it splits into): the identity off a mesh."""
    return constrain(y, "batch", *(None,) * (y.dim() - 1))


def _score_layout(x: torch.Tensor, logical: tuple, shape: tuple):
    """The reference's layout of the (B, H, Sq, Sk) fp32 scores on ``x``'s
    mesh -> (spec, this rank's share of ``shape``): ``spec_for_shape`` of
    the logical axes (``("batch", "heads", "seq_sharded", None)``, or
    ``("batch", None, "seq_sharded", None)`` in ``attn_shard="seq"`` mode),
    so ``model`` takes the heads where it divides them, the query positions
    where it does not, and neither for a decode step's one query.  (None,
    None) off a mesh."""
    if not is_dtensor(x):
        return None, None
    mesh = x.device_mesh
    spec = spec_for_shape(logical, shape, mesh)
    return spec, tuple(n // (axis_size(e, mesh) if e is not None else 1)
                       for n, e in zip(shape, spec))


def _own_share(scores: torch.Tensor, share: tuple | None) -> torch.Tensor:
    """``scores``, checked to be this rank's share and nothing more: a mesh
    path never computes whole scores where the reference splits them."""
    if share is not None and tuple(scores.shape) != share:
        raise RuntimeError(f"score block {tuple(scores.shape)} is not this rank's share {share}")
    return scores


def _attend(core, spec, q_like, kv_like, rows, q_pos, k_pos) -> torch.Tensor:
    """``core(*q_like, *kv_like, *rows, q_pos, k_pos)`` on each rank's share
    of the scores laid out by ``spec`` (batch, heads, query positions,
    keys): the (B, Sq, H, .) ``q_like`` tensors and the (B or 1, Sq)
    positions take their batch rows, query positions and heads; the (B,
    Sk, Hkv, .) ``kv_like`` tensors their batch rows and the kv heads of
    their query heads (a rank's q heads h read kv head h // n_rep, one kv
    head shared by several ranks where ``model`` splits the q heads more
    finely); the (B, Sk, .) ``rows`` and the (B or 1, Sk) key positions
    their batch rows, keys whole.  The output (B, Sq, H, .) is laid out as
    the query.  Off a mesh, ``core`` of the whole tensors."""
    if spec is None:
        return core(*q_like, *kv_like, *rows, q_pos, k_pos)
    bax, hax, sax, _ = spec
    b = q_like[0].shape[0]
    q_spec = (bax, sax, hax, None)
    return local_blocks(core, [(x, q_spec) for x in q_like]
                        + [(x, (bax, None, hax, None)) for x in kv_like]
                        + [(x, (bax,)) for x in rows]
                        + [(q_pos, (bax if q_pos.shape[0] == b else None, sax)),
                           (k_pos, (bax if k_pos.shape[0] == b else None, None))], q_spec)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) @ w (D, H, K) -> (B, S, H, K), one 2-D product."""
    d, h, k = w.shape
    return _flat(x @ pin(w.to(x.dtype).reshape(d, h * k))).reshape(*x.shape[:-1], h, k)


def _unproj(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y (B, S, H, K) @ w (H, K, D) -> (B, S, D), one 2-D product."""
    h, k, d = w.shape
    return pin(_flat(y).reshape(*y.shape[:-2], h * k)) @ pin(w.to(y.dtype).reshape(h * k, d))


# ------------------------------------------------------------------ GQA
def init_gqa(gen: torch.Generator | None, cfg: ArchConfig, dtype=torch.float32,
             device: torch.device | None = None):
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    s = 1.0 / math.sqrt(d)
    kw = dict(dtype=dtype, device=device)
    params = {
        "wq": nn.normal_init(gen, (d, hq, hd), s, **kw),
        "wk": nn.normal_init(gen, (d, hkv, hd), s, **kw),
        "wv": nn.normal_init(gen, (d, hkv, hd), s, **kw),
        "wo": nn.normal_init(gen, (hq, hd, d), 1.0 / math.sqrt(hq * hd), **kw),
    }
    axes = {
        "wq": ("embed", "heads", None),
        "wk": ("embed", "kv_heads", None),
        "wv": ("embed", "kv_heads", None),
        "wo": ("heads", None, "embed"),
    }
    return params, axes


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_cache, Hkv, hd) or MLA: c_kv (B, S_cache, kv_lora)
    v: torch.Tensor  # (B, S_cache, Hkv, hd) or MLA: k_rope (B, S_cache, rope_dim)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """q: (B,Sq,Hq,hd), k: (B,Sk,Hkv,hd) -> (B,Hq,Sq,Sk) fp32, without kv repeat."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = _flat(q).reshape(b, sq, hkv, n_rep, hd)
    sc = torch.einsum("bsgrh,btgh->bgrst", qg.float(), k.float())
    return sc.reshape(b, hq, sq, sk)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor, n_rep: int) -> torch.Tensor:
    b, hq, sq, sk = probs.shape
    hkv = v.shape[2]
    pg = _flat(probs).reshape(b, hkv, n_rep, sq, sk)
    out = torch.einsum("bgrst,btgh->bsgrh", pg, v.to(probs.dtype))
    return out.reshape(b, sq, hq, v.shape[3])


def gqa_attention(
    params: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, Sq, D)
    q_pos: torch.Tensor,  # (B, Sq) absolute positions
    *,
    window: int | None = None,
    cache: KVCache | None = None,
) -> tuple[torch.Tensor, KVCache | None]:
    dtype = x.dtype
    hq, hd = cfg.n_heads, cfg.resolved_head_dim
    seq_mode = cfg.attn_shard == "seq"
    q_ax = ("batch", "seq_sharded", "heads", None) if seq_mode else ("batch", None, "heads", None)
    kv_ax = ("batch", None, "kv_heads", None)
    q = constrain(_proj(x, params["wq"]), *q_ax)
    k = constrain(_proj(x, params["wk"]), *kv_ax)
    v = constrain(_proj(x, params["wv"]), *kv_ax)
    cos, sin = rope_freqs(hd, cfg.rope_theta, q_pos)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    sq = x.shape[1]
    ring = cache is not None and window is not None and cache.k.shape[1] <= window
    if cache is not None and ring and sq > 1:
        # local-layer PREFILL: attend in-sequence (mask enforces the window),
        # then write only the last min(S_cache, S) tokens — their ring slots
        # are unique, so the scatter is well-defined.
        k_pos = q_pos
        k_use, v_use = k, v
        s_cache = cache.k.shape[1]
        tail = min(s_cache, sq)
        slot = q_pos[:, -tail:] % s_cache
        _scatter_cache(cache.k, k[:, -tail:], slot)
        _scatter_cache(cache.v, v[:, -tail:], slot)
        new_cache = cache
    elif cache is not None:
        s_cache = cache.k.shape[1]
        if ring:
            slot = q_pos % s_cache  # decode: one unique slot per new token
            k_pos = _ring_positions(q_pos, s_cache)
        else:
            slot = q_pos
            k_pos = torch.arange(s_cache, dtype=q_pos.dtype,
                                 device=q_pos.device)[None, :].expand(x.shape[0], s_cache)
        _scatter_cache(cache.k, k, slot)
        _scatter_cache(cache.v, v, slot)
        new_cache = cache
        k_use, v_use = cache.k, cache.v
    else:
        new_cache = None
        k_pos = q_pos
        k_use, v_use = k, v

    scale = 1.0 / math.sqrt(hd)
    shape = (x.shape[0], hq, sq, k_use.shape[1])
    spec, share = _score_layout(q, ("batch", None, "seq_sharded", None) if seq_mode
                                else ("batch", "heads", "seq_sharded", None), shape)

    def core(q, k_use, v_use, q_pos, k_pos):  # a rank's share (the whole off a mesh)
        mask = causal_mask(q_pos, k_pos, window)[:, None, :, :]
        n_rep = q.shape[2] // k_use.shape[2]  # of this share's heads
        scores = _gqa_scores(q, k_use, n_rep) * scale  # (B,Hq,Sq,Sk) fp32
        scores = nn.softcap(_own_share(scores, share), cfg.attn_softcap)
        probs = torch.softmax(scores + mask, dim=-1).to(dtype)
        return _gqa_out(probs, v_use, n_rep)  # (B,Sq,Hq,hd)

    out = constrain(_attend(core, spec, (q,), (k_use, v_use), (), q_pos, k_pos), *q_ax)
    return _unproj(out, params["wo"]), new_cache


def _scatter_cache(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """cache (B,Sc,...), new (B,Sq,...), slot (B,Sq): rows written in place."""
    if is_dtensor(cache):
        return _scatter_cache_blocks(cache, new, slot)
    bidx = torch.arange(cache.shape[0], device=slot.device)[:, None].expand_as(slot)
    cache[bidx, slot.long()] = new.to(cache.dtype)
    return cache


@torch.no_grad()
def _scatter_cache_blocks(cache, new: torch.Tensor, slot: torch.Tensor):
    """``_scatter_cache`` into a DTensor cache laid out by batch and
    sequence (``("batch", "seq_sharded")``), each rank writing its own
    block: the new rows and slots are laid out by the cache's batch
    placements, and a rank keeps the rows whose slot falls in its
    sequence block [s0, s0 + n).  One new row a batch row (decode) is
    written at its slot clamped into the block, or the slot's own value
    written back where it falls outside; several (prefill; slots distinct
    in a row, as the caches' writers make them) through the inverse map
    slot -> row, which rewrites the block."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = cache.device_mesh
    rows = tuple(p if p.is_shard(0) else Replicate() for p in cache.placements)

    def laid_out(x):
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim)
        return x.redistribute(mesh, rows).to_local()

    block = cache.to_local()
    new_l, slot_l = laid_out(new).to(cache.dtype), laid_out(slot).long()
    s0, n = 0, int(cache.shape[1])
    coord = mesh.get_coordinate()
    for d, p in enumerate(cache.placements):
        if p.is_shard(1):
            blk = -(-n // mesh.size(d))
            start = min(coord[d] * blk, n)
            s0, n = s0 + start, min(n, start + blk) - start
    trail = (1,) * (block.dim() - 2)
    b = block.shape[0]
    if slot_l.shape[1] == 1:
        at = slot_l - s0
        inside = (at >= 0) & (at < n)
        at = at.clamp(0, n - 1)
        bidx = torch.arange(b, device=block.device)[:, None]
        block[bidx, at] = torch.where(inside.view(b, 1, *trail), new_l, block[bidx, at])
        return cache
    inv = torch.full((b, int(cache.shape[1])), -1, dtype=torch.long, device=block.device)
    inv.scatter_(1, slot_l, torch.arange(slot_l.shape[1], device=block.device).expand_as(slot_l))
    inv = inv[:, s0:s0 + n]
    rows_in = new_l[torch.arange(b, device=block.device)[:, None], inv.clamp(min=0)]
    block.copy_(torch.where((inv >= 0).view(b, n, *trail), rows_in, block))
    return cache


def _ring_positions(q_pos: torch.Tensor, s_cache: int) -> torch.Tensor:
    """Absolute positions currently living in each ring slot.

    After writing token t at slot t % Sc, slot j holds the largest position
    p <= max(q_pos) with p % Sc == j.
    """
    cur = q_pos.amax(dim=-1, keepdim=True)  # (B,1) newest position
    slots = torch.arange(s_cache, dtype=q_pos.dtype, device=q_pos.device)[None, :]
    delta = (cur % s_cache - slots) % s_cache
    return cur - delta  # (B, Sc); slots never written map to negative positions


# ------------------------------------------------------------------ MLA
def init_mla(gen: torch.Generator | None, cfg: ArchConfig, dtype=torch.float32,
             device: torch.device | None = None):
    d, h = cfg.d_model, cfg.n_heads
    nope, rope, vdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvl = cfg.kv_lora_rank
    s = 1.0 / math.sqrt(d)
    kw = dict(dtype=dtype, device=device)
    params: dict[str, Any] = {}
    axes: dict[str, Any] = {}
    if cfg.q_lora_rank:
        ql = cfg.q_lora_rank
        params["wdq"] = nn.normal_init(gen, (d, ql), s, **kw)
        params["q_norm"] = nn.rmsnorm_init(ql, **kw)
        params["wuq"] = nn.normal_init(gen, (ql, h, nope + rope), 1.0 / math.sqrt(ql), **kw)
        axes["wdq"] = ("embed", None)
        axes["q_norm"] = {"scale": (None,)}
        axes["wuq"] = (None, "heads", None)
    else:
        params["wq"] = nn.normal_init(gen, (d, h, nope + rope), s, **kw)
        axes["wq"] = ("embed", "heads", None)
    params["wdkv"] = nn.normal_init(gen, (d, kvl), s, **kw)
    params["kv_norm"] = nn.rmsnorm_init(kvl, **kw)
    params["wkr"] = nn.normal_init(gen, (d, rope), s, **kw)
    params["wuk"] = nn.normal_init(gen, (kvl, h, nope), 1.0 / math.sqrt(kvl), **kw)
    params["wuv"] = nn.normal_init(gen, (kvl, h, vdim), 1.0 / math.sqrt(kvl), **kw)
    params["wo"] = nn.normal_init(gen, (h, vdim, d), 1.0 / math.sqrt(h * vdim), **kw)
    axes.update(
        {
            "wdkv": ("embed", None),
            "kv_norm": {"scale": (None,)},
            "wkr": ("embed", None),
            "wuk": (None, "heads", None),
            "wuv": (None, "heads", None),
            "wo": ("heads", None, "embed"),
        }
    )
    return params, axes


def mla_attention(
    params: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    q_pos: torch.Tensor,
    *,
    cache: KVCache | None = None,
    window: int | None = None,  # unused (MLA layers are global)
) -> tuple[torch.Tensor, KVCache | None]:
    """Multi-head Latent Attention (DeepSeek-V2/V3).

    The cache stores the COMPRESSED latent (c_kv, k_rope) — the paper's
    memory saving — and decode re-expands it per step through wuk/wuv.
    """
    dtype = x.dtype
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    b = x.shape[0]

    # the low-rank projections laid out by batch (``_flat``), their
    # gradients too: DTensor would split them over the sequence
    if cfg.q_lora_rank:
        cq = nn.rmsnorm(params["q_norm"], _flat(x @ params["wdq"].to(dtype)))
        q = _proj(cq, params["wuq"])
    else:
        q = _proj(x, params["wq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = rope_freqs(rope, cfg.rope_theta, q_pos)
    q_rope = apply_rope(q_rope, cos, sin)

    c_kv = _flat(x @ params["wdkv"].to(dtype))  # (B,S,kvl)
    k_r = _flat(x @ params["wkr"].to(dtype))[:, :, None, :]  # (B,S,1,rope)
    k_r = apply_rope(k_r, cos, sin)[:, :, 0, :]  # (B,S,rope)

    if cache is not None:
        s_cache = cache.k.shape[1]
        _scatter_cache(cache.k, c_kv, q_pos)
        _scatter_cache(cache.v, k_r, q_pos)
        new_cache = cache
        k_pos = torch.arange(s_cache, dtype=q_pos.dtype, device=q_pos.device)[None, :].expand(b, s_cache)
        # a sequence-sharded cache read whole: its re-expansion flattens
        # (B, S), which DTensor cannot do with both dimensions sharded
        c_use, kr_use = (constrain(c, "batch", None, None) for c in (cache.k, cache.v))
    else:
        new_cache = None
        k_pos = q_pos
        c_use, kr_use = c_kv, k_r

    # the latent's own dtype, promoted with the compute dtype as the
    # reference's mixed-dtype products are
    c_n = nn.rmsnorm(params["kv_norm"], c_use).to(torch.promote_types(c_use.dtype, dtype))
    k_nope = constrain(_proj(c_n, params["wuk"]), "batch", None, "heads", None)
    v = constrain(_proj(c_n, params["wuv"]), "batch", None, "heads", None)

    scale = 1.0 / math.sqrt(nope + rope)
    pv = torch.promote_types(dtype, v.dtype)
    shape = (b, cfg.n_heads, x.shape[1], k_nope.shape[1])
    spec, share = _score_layout(q_nope, ("batch", "heads", "seq_sharded", None), shape)

    def core(q_nope, q_rope, k_nope, v, kr_use, q_pos, k_pos):  # a rank's share
        sc = torch.einsum("bshk,bthk->bhst", q_nope.float(), k_nope.float())
        sc = sc + torch.einsum("bshk,btk->bhst", q_rope.float(), kr_use.float())
        mask = causal_mask(q_pos, k_pos)[:, None, :, :]
        probs = torch.softmax(_own_share(sc, share) * scale + mask, dim=-1).to(dtype)
        return torch.einsum("bhst,bthv->bshv", probs.to(pv), v)

    out = _attend(core, spec, (q_nope, q_rope), (k_nope, v), (kr_use,), q_pos, k_pos)
    return _unproj(out, params["wo"]), new_cache
