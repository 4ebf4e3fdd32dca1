"""MeshGraphNet (Pfaff et al., arXiv:2010.03409): encode-process-decode GNN.

Message passing gathers node states at edge endpoints, MLPs the
concatenation and scatter-adds it back to the receivers (the reference's
``jax.ops.segment_sum`` is an ``index_add`` into zeros of (N, H) here).
On CUDA the scatter-add and the gathers' backward use atomics, so two runs
on the card may differ in the last bits; on the CPU both are serial, and a
step is deterministic.
Unlike ``segment_sum``, ``index_add`` raises on a receiver id outside
[0, N): the cells' padded graphs keep every id in range.

Graphs are padded to static (n_nodes, n_edges); ``node_mask``/``edge_mask``
zero out padding.  The neighbor sampler (minibatch_lg shape) lives in
sampler.py and produces these padded subgraphs.  The model is a
``ParamTree`` under the reference's names: ``node_enc``, ``edge_enc``,
``node_enc_ln``, ``edge_enc_ln``, ``layers[i].{edge_mlp,node_mlp,edge_ln,
node_ln}``, ``decoder``.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common import nn
from repro_torch.common.config import ArchConfig
from repro_torch.common.device import init_generator, resolve_device
from repro_torch.common.sharding import is_dtensor, local_rows

Axes = tuple  # logical axis names of one parameter, one a dim


def _mlp_dims(cfg: ArchConfig, d_in: int) -> list[int]:
    return [d_in] + [cfg.gnn_hidden] * cfg.gnn_mlp_layers


def init_mgn(seed: int | torch.Generator, cfg: ArchConfig, dtype=torch.float32, *,
             device: str | torch.device = "cuda") -> tuple[nn.ParamTree, dict[str, Axes]]:
    """-> (model, {state-dict name: logical axes}), the reference's
    structure and scales drawn from a generator on ``device``."""
    gen, dev = init_generator(seed, device)
    kw = dict(dtype=dtype, device=dev)
    h = cfg.gnn_hidden
    tree: dict[str, Any] = {
        "node_enc": nn.mlp_init(gen, _mlp_dims(cfg, cfg.node_feat_dim), **kw),
        "edge_enc": nn.mlp_init(gen, _mlp_dims(cfg, cfg.edge_feat_dim), **kw),
        # MGN paper: every MLP output is LayerNorm'd except the decoder's
        "node_enc_ln": nn.layernorm_init(h, **kw),
        "edge_enc_ln": nn.layernorm_init(h, **kw),
    }
    enc_axes = nn.mlp_axes(cfg.gnn_mlp_layers)
    axes: dict[str, Any] = {"node_enc": enc_axes, "edge_enc": enc_axes,
                            "node_enc_ln": nn.LAYERNORM_AXES, "edge_enc_ln": nn.LAYERNORM_AXES}
    tree["layers"] = [
        {"edge_mlp": nn.mlp_init(gen, _mlp_dims(cfg, 3 * h), **kw),
         "node_mlp": nn.mlp_init(gen, _mlp_dims(cfg, 2 * h), **kw),
         "edge_ln": nn.layernorm_init(h, **kw), "node_ln": nn.layernorm_init(h, **kw)}
        for _ in range(cfg.gnn_layers)]
    axes["layers"] = [{"edge_mlp": enc_axes, "node_mlp": enc_axes, "edge_ln": nn.LAYERNORM_AXES,
                       "node_ln": nn.LAYERNORM_AXES} for _ in range(cfg.gnn_layers)]
    tree["decoder"] = nn.mlp_init(gen, [h, h, cfg.gnn_out_dim], **kw)
    axes["decoder"] = nn.mlp_axes(2)
    return nn.ParamTree(tree), nn.flat_axes(axes)


def mgn_params_from_jax(params_np: Any, cfg: ArchConfig, *,
                        device: str | torch.device = "cuda") -> nn.ParamTree:
    """The reference's MGN params (arrays as numpy, or anything
    ``np.asarray`` reads) as the port's model, leaf for leaf."""
    model = nn.ParamTree(nn.tree_to_torch(params_np, resolve_device(device)))
    if len(model["layers"]) != cfg.gnn_layers:
        raise ValueError(f"{len(model['layers'])} layers for {cfg.name}'s {cfg.gnn_layers}")
    return model


def mgn_forward(model: nn.ParamTree, cfg: ArchConfig, batch: Mapping[str, torch.Tensor],
                remat: bool = False) -> torch.Tensor:
    """batch: node_feat (N, F), edge_feat (E, Fe), senders (E,), receivers (E,),
    node_mask (N,), edge_mask (E,). Returns (N, out_dim)."""
    v = nn.layernorm(model["node_enc_ln"], nn.mlp(model["node_enc"], batch["node_feat"], act=F.relu))
    e = nn.layernorm(model["edge_enc_ln"], nn.mlp(model["edge_enc"], batch["edge_feat"], act=F.relu))
    snd, rcv = batch["senders"].long(), batch["receivers"].long()
    emask = batch["edge_mask"][:, None].to(v.dtype)
    n = v.shape[0]

    def gather(e, snd, rcv, v):
        # index_select, whose backward is an index_add: serial on the CPU, so
        # a step there is deterministic (indexing's accumulates in parallel)
        return torch.cat([e, v.index_select(0, snd), v.index_select(0, rcv)], dim=-1)

    def scatter(rcv, x):
        return x.new_zeros((n, x.shape[1])).index_add(0, rcv, x)

    def one_layer(v, e, layer):
        # edge update: e' = e + LN(MLP([e, v_src, v_dst])); on a mesh each
        # rank's edges read the whole node table (gathered) ...
        msg_in = local_rows(gather, (e, snd, rcv), (v,))
        upd = nn.layernorm(layer["edge_ln"], nn.mlp(layer["edge_mlp"], msg_in, act=F.relu))
        e = e + upd * emask
        # node update: v' = v + LN(MLP([v, Σ_incoming e'])); ... and add
        # into a whole one, summed over the ranks and laid out as the nodes
        agg = _as_nodes(local_rows(scatter, (rcv, e * emask), partial_out=True), v)
        if cfg.gnn_aggregator == "mean":
            deg = _as_nodes(local_rows(scatter, (rcv, emask), partial_out=True), v)
            agg = agg / torch.clamp(deg, min=1.0)
        v = v + nn.layernorm(
            layer["node_ln"], nn.mlp(layer["node_mlp"], torch.cat([v, agg], dim=-1), act=F.relu))
        return v, e

    for layer in model["layers"]:
        if remat and torch.is_grad_enabled():
            # per-layer activation checkpointing: keep v and e, recompute the rest
            v, e = checkpoint(one_layer, v, e, layer, use_reentrant=False)
        else:
            v, e = one_layer(v, e, layer)

    return nn.mlp(model["decoder"], v, act=F.relu)


def _as_nodes(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A whole-shaped node array laid out as the node table ``v``."""
    if not is_dtensor(x):
        return x
    return x.redistribute(v.device_mesh, v.placements)


def mgn_loss(model: nn.ParamTree, cfg: ArchConfig, batch: Mapping[str, torch.Tensor],
             remat: bool = False) -> torch.Tensor:
    """MSE on node targets, masked over padding."""
    pred = mgn_forward(model, cfg, batch, remat=remat)
    mask = batch["node_mask"][:, None].to(pred.dtype)
    err = (pred - batch["node_targets"]).square() * mask
    return err.sum() / torch.clamp(mask.sum() * cfg.gnn_out_dim, min=1.0)
