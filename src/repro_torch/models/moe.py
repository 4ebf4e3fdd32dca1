"""Mixture-of-Experts FFN with grouped capacity dispatch (GShard-style) and
aux-loss-free bias balancing (DeepSeek-V3).

Dispatch: routing groups are batch rows, so a slot's position within its
expert is an exclusive count along the row's (token, choice) slots in slot
order — no sort.  A batched scatter builds (B, E, C+1, d) expert buffers,
the expert products run all experts at once, and combine is a k-way
weighted gather back.

Capacity C = ceil(top_k · S / E · capacity_factor) per group; overflow goes
to a trash row ``C`` (GShard semantics) that combine discards.  Only the
trash row takes more than one slot, so the order in which duplicate writes
land cannot change a result.  Expert choice breaks ties toward the lower
expert index, as the reference's ``top_k`` does: which slots overflow
depends on it.
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F

from repro_torch.common import nn
from repro_torch.common.config import ArchConfig
from repro_torch.common.sharding import (as_spec, constrain, current_mesh, is_dtensor,
                                         local_rows, mesh_size)

CAPACITY_FACTOR = 1.25

Params = Mapping[str, Any]


def init_moe(gen: torch.Generator | None, cfg: ArchConfig, dtype=torch.float32,
             device: torch.device | None = None):
    d, e, f = cfg.d_model, cfg.n_routed_experts, cfg.moe_d_ff
    s = 1.0 / math.sqrt(d)
    kw = dict(dtype=dtype, device=device)
    params = {
        "router": nn.normal_init(gen, (d, e), s, dtype=torch.float32, device=device),
        "bias": torch.zeros((e,), dtype=torch.float32, device=device),  # aux-loss-free bias
        "w_gate": nn.normal_init(gen, (e, d, f), s, **kw),
        "w_up": nn.normal_init(gen, (e, d, f), s, **kw),
        "w_down": nn.normal_init(gen, (e, f, d), 1.0 / math.sqrt(f), **kw),
    }
    axes = {
        "router": (None, None),
        "bias": (None,),
        "w_gate": ("experts", "embed", "mlp"),
        "w_up": ("experts", "embed", "mlp"),
        "w_down": ("experts", "mlp", "embed"),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        params["shared_gate"] = nn.normal_init(gen, (d, fs), s, **kw)
        params["shared_up"] = nn.normal_init(gen, (d, fs), s, **kw)
        params["shared_down"] = nn.normal_init(gen, (fs, d), 1.0 / math.sqrt(fs), **kw)
        axes["shared_gate"] = ("embed", "mlp")
        axes["shared_up"] = ("embed", "mlp")
        axes["shared_down"] = ("mlp", "embed")
    return params, axes


def moe_dispatch(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Entry point: explicit all-to-all expert parallelism (``cfg.moe_a2a``)
    under a mesh of more than one rank where it applies (the expert count
    divides the expert ranks, the batch the data ranks, and a data block's
    tokens the model ranks), else the grouped path.  Both give the same
    outputs at equal capacity."""
    if getattr(cfg, "moe_a2a", False):
        from repro_torch.models.moe_a2a import moe_a2a_applicable, moe_ffn_a2a

        # the tensor's mesh (a recompute in the backward runs outside the context)
        mesh = x.device_mesh if is_dtensor(x) else current_mesh()
        if mesh is not None and mesh_size(mesh) > 1 and moe_a2a_applicable(cfg, mesh):
            b, s, d = x.shape
            sizes = as_spec(mesh).shape
            dp = sizes.get("pod", 1) * sizes.get("data", 1)
            mp = sizes.get("model", 1)
            if b % dp == 0 and (b // dp) * s % mp == 0:
                y = moe_ffn_a2a(params, cfg, x)
                return y + _shared(params, x) if cfg.n_shared_experts else y
    return moe_ffn(params, cfg, x)


def top_k_lowest_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index (the
    reference's ``top_k``); ``torch.topk`` promises no order among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params: Params, cfg: ArchConfig, x: torch.Tensor):
    # (B,S,E) fp32, laid out by batch, its gradient too: DTensor would
    # otherwise split it over the sequence, which the backward flattens
    logits = constrain(x.float() @ params["router"].float(), "batch", None, None)
    gate = torch.sigmoid(logits) if cfg.moe_aux_free else torch.softmax(logits, dim=-1)
    # aux-loss-free: bias steers SELECTION only, not combine weights (dsv3 §3.2)
    sel = gate + params["bias"][None, None, :] if cfg.moe_aux_free else gate
    return gate, top_k_lowest_index(sel, cfg.top_k)[1]


def _shared(params: Params, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    g = constrain(x @ params["shared_gate"].to(dtype), "batch", None, "mlp")
    u = constrain(x @ params["shared_up"].to(dtype), "batch", None, "mlp")
    return (F.silu(g) * u) @ params["shared_down"].to(dtype)


def capacity(cfg: ArchConfig, s: int) -> int:
    """Slots an expert takes from one group (batch row) of ``s`` tokens."""
    k, e = cfg.top_k, cfg.n_routed_experts
    cf = getattr(cfg, "moe_capacity_factor", CAPACITY_FACTOR)
    return max(1, min(int(math.ceil(k * s / e * cf)), s * k))


def _slots(top_idx: torch.Tensor, e: int, cap: int):
    """(B, S, k) expert choices -> (expert, row, dropped) of each of the
    (B, S*k) slots: the row is the slot's exclusive count among the earlier
    slots of its group that chose the same expert, or the trash row ``cap``
    once the expert is full."""
    b = top_idx.shape[0]
    flat_e = top_idx.reshape(b, -1)  # (B, S*k) expert of each slot
    onehot = F.one_hot(flat_e, e).to(torch.int32)  # (B, S*k, E)
    pos = (torch.cumsum(onehot, dim=1) - 1).gather(-1, flat_e[..., None])[..., 0]
    dropped = pos >= cap
    pos_c = torch.where(dropped, torch.full_like(pos, cap), pos).long()
    return flat_e, pos_c, dropped


def _experts(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor
             ) -> torch.Tensor:
    """The routed experts' FFN: buf (B, E, C, D) -> (B, E, C, D), each
    expert on its own slots.  On a mesh, each rank runs its experts
    (``local_rows`` over the expert dimension, slots and weights split
    alike): DTensor cannot multiply a flattened (B, C) that the mesh splits
    on both sides."""
    if not is_dtensor(buf):
        h = F.silu(torch.einsum("becd,edf->becf", buf, wg)) * torch.einsum("becd,edf->becf", buf, wu)
        return torch.einsum("becf,efd->becd", h, wd)

    def ffn(x, g, u, w):  # x (E_local, B, C, D)
        h = F.silu(torch.einsum("ebcd,edf->ebcf", x, g)) * torch.einsum("ebcd,edf->ebcf", x, u)
        return torch.einsum("ebcf,efd->ebcd", h, w)

    xe = constrain(buf.permute(1, 0, 2, 3), "experts", None, None, None)
    return local_rows(ffn, (xe, wg, wu, wd)).permute(1, 0, 2, 3)


def moe_ffn(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D). Dispatch groups = batch rows."""
    dtype = x.dtype
    b, s, d = x.shape
    e, k = cfg.n_routed_experts, cfg.top_k

    gate, top_idx = _route(params, cfg, x)  # (B,S,k)
    top_w = gate.gather(-1, top_idx)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    cap = capacity(cfg, s)
    flat_e, pos_c, dropped = _slots(top_idx, e, cap)

    def dispatch(x, flat_e, pos_c):  # row `cap` collects drops
        b = x.shape[0]
        tok = torch.arange(s * k, device=x.device) // k  # slot -> token within row
        bidx = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
        buf = torch.zeros((b, e, cap + 1, d), dtype=dtype, device=x.device)
        return buf.index_put((bidx, flat_e, pos_c), x[:, tok])

    def combine(out, flat_e, pos_c):  # (B, S*k, d)
        bidx = torch.arange(out.shape[0], device=out.device)[:, None].expand_as(flat_e)
        return out[bidx, flat_e, pos_c]

    # on a mesh the slots are placed and read on each rank's batch rows
    # (``local_rows``), and the buffer moves between them and the experts
    buf = constrain(local_rows(dispatch, (x, flat_e, pos_c)), None, "experts", None, None)
    out = _experts(buf, *(params[w].to(dtype) for w in ("w_gate", "w_up", "w_down")))
    out = constrain(out, None, "experts", None, None)
    slot_out = local_rows(combine, (constrain(out, "batch", None, None, None), flat_e, pos_c))
    slot_out = torch.where(dropped[..., None], torch.zeros((), dtype=dtype, device=x.device),
                           slot_out)
    y = (slot_out.reshape(b, s, k, d) * top_w[..., None].to(dtype)).sum(dim=2)

    if cfg.n_shared_experts:
        y = y + _shared(params, x)
    return y


def load_balance_stats(params: Params, cfg: ArchConfig, x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Expert load histogram (for the bias-update controller)."""
    logits = x.float() @ params["router"].float()
    gate = torch.sigmoid(logits) if cfg.moe_aux_free else torch.softmax(logits, dim=-1)
    _, top_idx = top_k_lowest_index(gate + params["bias"][None, None, :], cfg.top_k)
    load = torch.zeros(cfg.n_routed_experts, device=x.device).index_add_(
        0, top_idx.reshape(-1), torch.ones(top_idx.numel(), device=x.device))
    return {"load": load, "mean": load.mean()}


def update_balance_bias(bias: torch.Tensor, load: torch.Tensor, lr: float = 1e-3) -> torch.Tensor:
    """dsv3 §3.2: nudge bias down for overloaded experts, up for underloaded."""
    err = load.mean() - load
    return bias + lr * torch.sign(err)
