"""Expert-parallel MoE FFN with an EXPLICIT token all-to-all.

The grouped ``moe_ffn`` builds every expert's buffer on every rank; on a
mesh this module moves ONLY routed tokens:

  per rank (combined expert axis = data×model, n_ep ranks, data-major):
    1. own a disjoint slice of the local tokens (model-axis round-robin:
       token r of the rank's data block belongs to model rank r % mp);
    2. route top-k, bucket slots by destination rank with per-(src,dst)
       capacity C = max(1, min(ceil(n·k/n_ep·cf), n·k)) (+1 trash row);
    3. all_to_all the (n_ep, C+1, d) buckets + metadata (three all-to-alls);
    4. run the resident experts on arrivals; all_to_all back (one);
    5. combine k weighted returns, psum-merge the model-axis slices.

One departure from the reference: it runs every local expert on every
arrived row and keeps the row's own with ``where`` (one expert a rank on
its production mesh).  With 64 experts a rank on four ranks that is 64x
the products, so here each arrived row goes through its own expert only.
Rows are independent, so the result is the same within float rounding
(the products see other row counts).

``moe_a2a_ref`` is a one-process plain version of the same function for
checking it, written apart from ``route_slots``: its own top-k, a loop
over the slots for the per-(source, destination) positions and drops,
each kept slot through its expert, the experts given one at a time.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.common.config import ArchConfig
from repro_torch.common.sharding import (as_spec, axis_index, current_mesh, is_dtensor,
                                         mesh_size, placements, shard_map)
from repro_torch.distributed.comm import all_to_all, psum
from repro_torch.models.moe import CAPACITY_FACTOR, top_k_lowest_index

Expert = Callable[[int], tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _axes_present(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("data", "model") if a in as_spec(mesh).axis_names)


def moe_a2a_applicable(cfg: ArchConfig, mesh=None) -> bool:
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or mesh_size(mesh) <= 1:
        return False
    axes = _axes_present(mesh)
    if not axes:
        return False
    sizes = as_spec(mesh).shape
    return cfg.n_routed_experts % math.prod(sizes[a] for a in axes) == 0


def a2a_capacity(cfg: ArchConfig, n: int, n_ep: int) -> int:
    """Slots a source rank of ``n`` tokens sends one destination rank."""
    k = cfg.top_k
    cf = getattr(cfg, "moe_capacity_factor", CAPACITY_FACTOR)
    return max(1, min(int(math.ceil(n * k / n_ep * cf)), n * k))


def route_slots(mine: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, cfg: ArchConfig,
                n_ep: int):
    """One source rank's routing: (n, d) tokens -> (top_idx (n, k), top_w
    (n, k) fp32, dest (n·k,), local expert (n·k,), position (n·k,) clipped
    to the trash row ``cap``, dropped (n·k,), cap)."""
    n, k = mine.shape[0], cfg.top_k
    e_loc = cfg.n_routed_experts // n_ep
    logits = mine.float() @ router.float()
    gate = torch.sigmoid(logits) if cfg.moe_aux_free else torch.softmax(logits, -1)
    sel = gate + bias[None, :] if cfg.moe_aux_free else gate
    top_idx = top_k_lowest_index(sel, k)[1]  # (n, k), ties to the lower expert
    top_w = gate.gather(1, top_idx)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    cap = a2a_capacity(cfg, n, n_ep)
    flat_e = top_idx.reshape(-1)
    dest = flat_e // e_loc
    onehot = F.one_hot(dest, n_ep).to(torch.int32)
    pos = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1)  # exclusive count, slot order
    dropped = pos >= cap
    pos_c = torch.where(dropped, torch.full_like(pos, cap), pos)
    return top_idx, top_w, dest, flat_e % e_loc, pos_c, dropped, cap


def moe_a2a_local(xs: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
                  wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, cfg: ArchConfig,
                  mesh=None, *, merge: bool = True) -> torch.Tensor:
    """One rank's part: its data block xs (B_loc, S, D) and its experts
    w* (E_loc, ·, ·) -> its block of the routed output (B_loc, S, D).  With
    ``merge=False`` the model-axis slices are not summed: each rank returns
    its own slice's rows and zeros elsewhere (a partial sum over model)."""
    mesh = mesh if mesh is not None else current_mesh()
    axes = _axes_present(mesh)
    sizes = as_spec(mesh).shape
    n_ep = math.prod(sizes[a] for a in axes)
    mp = sizes.get("model", 1)
    e_loc = cfg.n_routed_experts // n_ep
    if wg.shape[0] != e_loc:
        raise ValueError(f"{wg.shape[0]} local experts, {cfg.n_routed_experts} over {n_ep} ranks")
    k, d = cfg.top_k, xs.shape[-1]
    dtype, dev = xs.dtype, xs.device
    b_loc, s, _ = xs.shape
    flat = xs.reshape(-1, d)
    mj = axis_index("model", mesh) if "model" in axes else 0
    mine = flat.reshape(-1, mp, d)[:, mj] if mp > 1 else flat  # disjoint token slice
    n = mine.shape[0]

    _, top_w, dest, le, pos_c, dropped, cap = route_slots(mine, router, bias, cfg, n_ep)
    tok = torch.arange(n * k, device=dev) // k
    send = torch.zeros((n_ep, cap + 1, d), dtype=dtype, device=dev)
    send[dest, pos_c] = mine[tok]  # row `cap` collects the drops
    send_le = torch.zeros((n_ep, cap + 1), dtype=torch.int32, device=dev)
    send_le[dest, pos_c] = le.to(torch.int32)
    send_ok = torch.zeros((n_ep, cap + 1), dtype=torch.bool, device=dev)
    send_ok[dest, pos_c] = ~dropped
    send_ok[:, cap] = False  # the trash row is never valid

    recv = all_to_all(send, axes, mesh)
    recv_le = all_to_all(send_le, axes, mesh)
    recv_ok = all_to_all(send_ok, axes, mesh)
    del send

    rows = recv.reshape(-1, d)
    rle = recv_le.reshape(-1)
    rok = recv_ok.reshape(-1)
    out_rows = torch.zeros_like(rows)
    planned = is_fake(rows)  # a dry run: the routing's row counts are unknown
    for j in range(e_loc):  # each arrived row through its own expert only
        if planned:  # every arrived slot, masked: the work at capacity
            h = F.silu(rows @ wg[j].to(dtype)) * (rows @ wu[j].to(dtype))
            out_rows = torch.where(((rle == j) & rok)[:, None], h @ wd[j].to(dtype), out_rows)
            continue
        # an expert that got no row still runs (on none), so that every
        # rank's out_rows needs a gradient alike and the backward's
        # all-to-all runs on every rank
        idx = torch.nonzero((rle == j) & rok).squeeze(1)
        r = rows[idx]
        h = F.silu(r @ wg[j].to(dtype)) * (r @ wu[j].to(dtype))
        out_rows[idx] = h @ wd[j].to(dtype)
    del recv, rows

    back = all_to_all(out_rows.reshape(n_ep, cap + 1, d), axes, mesh)
    slot_out = back[dest, pos_c]  # (n*k, d) aligned with the send slots
    slot_out = torch.where(dropped[:, None], torch.zeros((), dtype=dtype, device=dev), slot_out)
    y_mine = (slot_out.reshape(n, k, d) * top_w[..., None].to(dtype)).sum(1)

    if mp > 1:  # merge the model-axis slices
        y_full = torch.zeros((flat.shape[0] // mp, mp, d), dtype=dtype, device=dev)
        y_full[:, mj] = y_mine
        y_full = (psum(y_full, "model", mesh) if merge else y_full).reshape(-1, d)
    else:
        y_full = y_mine
    return y_full.reshape(b_loc, s, d)


def _specs(mesh):
    names = as_spec(mesh).axis_names
    axes = _axes_present(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    x_spec = (data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None),
              None, None)
    ep = axes if len(axes) > 1 else axes[0]
    return x_spec, (ep, None, None)


def moe_ffn_a2a(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Routed-expert part only (the shared experts are added by the caller).

    x (B, S, D), the global batch on every rank, or a DTensor laid out by
    the data axes; the expert weights global, or DTensors sharded over
    (data, model).  -> y (B, S, D) on every rank.  Call only when
    ``moe_a2a_applicable``."""
    if is_dtensor(x):
        return _moe_a2a_dtensor(params, cfg, x, x.device_mesh)
    mesh = current_mesh()
    x_spec, w_spec = _specs(mesh)

    def inner(xs, router, bias, wg, wu, wd):
        return moe_a2a_local(xs, router, bias, wg, wu, wd, cfg, mesh)

    return shard_map(inner, mesh, in_specs=(x_spec, (None, None), (None,), w_spec, w_spec, w_spec),
                     out_specs=x_spec)(
        x, params["router"], params["bias"], params["w_gate"], params["w_up"], params["w_down"])


def _moe_a2a_dtensor(params, cfg: ArchConfig, x, mesh):
    """``moe_ffn_a2a`` of a DTensor ``x``: each rank runs ``moe_a2a_local``
    on its blocks, and the result stays laid out as ``x`` over the data
    axes and partial over model (each model rank's token slice), which the
    next op reduces as it needs (a ``shard_map`` output would be gathered
    whole on every rank).  Gradients by the same layouts: ``x``'s partial
    over model, the router's partial over the mesh, each rank's experts
    its own."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    x_spec, w_spec = _specs(mesh)
    names = list(as_spec(mesh).axis_names)

    def over(spec):
        return placements(spec, mesh)

    x_pl = over(x_spec)
    x_grad = tuple(Partial() if names[d] == "model" else p for d, p in enumerate(x_pl))
    xs = x.redistribute(mesh, x_pl).to_local(grad_placements=x_grad)
    every = (Partial(),) * mesh.ndim
    router, bias = (params[k].redistribute(mesh, (Replicate(),) * mesh.ndim)
                    .to_local(grad_placements=every) for k in ("router", "bias"))
    wg, wu, wd = (params[k].redistribute(mesh, over(w_spec)).to_local(
        grad_placements=over(w_spec)) for k in ("w_gate", "w_up", "w_down"))
    y = moe_a2a_local(xs, router, bias, wg, wu, wd, cfg, mesh, merge=False)
    y_pl = tuple(Partial() if names[d] == "model" else p for d, p in enumerate(x_pl))
    return DTensor.from_local(y, mesh, y_pl, shape=x.shape, stride=x.stride())


def moe_a2a_ref(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, experts: Expert,
                cfg: ArchConfig, dp: int, mp: int) -> tuple[torch.Tensor, float]:
    """Plain one-process version of ``moe_ffn_a2a`` on a (dp, mp) mesh:
    x (B, S, D) global -> (the routed output (B, S, D), the share of
    slots dropped).  Written on its own terms, apart from the routing the
    mesh path uses: each source rank's tokens pick their top-k experts by
    repeated ``argmax`` (ties to the lower expert), a Python loop over the
    slots in order counts what each destination has taken and drops what
    exceeds the capacity, and each kept slot goes through its expert, the
    experts taken one at a time from ``experts``."""
    b, s, d = x.shape
    n_ep, k, n_exp = dp * mp, cfg.top_k, cfg.n_routed_experts
    e_loc = n_exp // n_ep
    dtype = x.dtype
    flat = x.reshape(dp, -1, mp, d)  # (data block, token // mp, model owner, d)
    n = flat.shape[1]
    cf = getattr(cfg, "moe_capacity_factor", CAPACITY_FACTOR)
    cap = max(1, min(int(math.ceil(n * k / n_ep * cf)), n * k))
    kept: list[list] = [[] for _ in range(n_exp)]  # expert -> (source, token, weight)
    dropped = 0
    for i in range(dp):
        for j in range(mp):
            logits = flat[i, :, j].float() @ router.float()
            gate = torch.sigmoid(logits) if cfg.moe_aux_free else torch.softmax(logits, -1)
            sel = gate + bias[None, :] if cfg.moe_aux_free else gate.clone()
            picks = []
            for _ in range(k):  # argmax returns the first of equal maxima
                e = sel.argmax(-1)
                picks.append(e)
                sel.scatter_(1, e[:, None], float("-inf"))
            top = torch.stack(picks, 1)  # (n, k)
            w = gate.gather(1, top)
            w = (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)).tolist()
            taken = [0] * n_ep
            for slot, e in enumerate(top.reshape(-1).tolist()):  # token-major slot order
                dst = e // e_loc
                if taken[dst] < cap:
                    kept[e].append(((i, j), slot // k, w[slot // k][slot % k]))
                else:
                    dropped += 1
                taken[dst] += 1
    y = torch.zeros_like(flat)
    for e in range(n_exp):
        if not kept[e]:
            continue
        wg, wu, wd = experts(e)
        for src in {c[0] for c in kept[e]}:
            tok = torch.tensor([c[1] for c in kept[e] if c[0] == src], device=x.device)
            wt = torch.tensor([c[2] for c in kept[e] if c[0] == src], dtype=torch.float32,
                              device=x.device)
            rows = flat[src[0], tok, src[1]]
            h = F.silu(rows @ wg.to(dtype)) * (rows @ wu.to(dtype))
            y[src[0], :, src[1]].index_add_(0, tok, (h @ wd.to(dtype)) * wt.to(dtype)[:, None])
    return y.reshape(b, s, d), dropped / (dp * mp * n * k)
