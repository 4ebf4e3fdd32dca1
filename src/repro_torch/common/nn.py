"""Tiny functional NN layer helpers shared across model families.

The reference's helpers as functions on tensors: parameters are plain
mappings of tensors (a ``dict``, or a ``ParamTree`` when a module owns
them), layers are functions.  The weight layout is the reference's,
``x @ w`` with ``w`` of shape (d_in, d_out), so its weights carry across as
copies with no transpose.  Inits draw from a seeded ``torch.Generator``
(normal x 1/sqrt(d_in) for dense weights, zero biases) on the generator's
device, or give shapes only on the meta device.  The reference's
sharding-axes twin trees are flat ``{state-dict name: logical axes}``
maps here (``flat_axes``, ``mlp_axes``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn as tnn

from repro_torch.common.sharding import (_axes, axis_size, is_dtensor, local_blocks,
                                         local_rows, spec_for_shape)

Params = Mapping[str, torch.Tensor]


class ParamTree(tnn.Module):
    """A tree of parameters indexed like the reference's pytrees: each
    tensor becomes an ``nn.Parameter``, each mapping a child ``ParamTree``,
    each list a ``ModuleList`` of child trees (a ``ParameterList`` when its
    items are tensors).  State-dict names are the tree's paths, e.g.
    ``layers.3.edge_mlp.0.w`` or ``tables.25``."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, (list, tuple)):
                if all(isinstance(x, torch.Tensor) for x in v):
                    self.add_module(k, tnn.ParameterList(v))
                else:
                    self.add_module(k, tnn.ModuleList(ParamTree(x) for x in v))
            else:
                self.register_parameter(k, tnn.Parameter(v))

    def __getitem__(self, k: str):
        return getattr(self, k)

    def __contains__(self, k: str) -> bool:
        return k in self._parameters or k in self._modules


def flat_axes(tree: Any, prefix: str = "", out: dict | None = None) -> dict[str, tuple]:
    """A logical-axes tree (mappings and lists of subtrees, a tuple a leaf)
    -> {state-dict name: axes}, under ``ParamTree``'s names."""
    out = {} if out is None else out
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (Mapping, list)):
            flat_axes(v, name, out)
        else:
            out[name] = tuple(v)
    return out


def _to_torch(a: Any, device: torch.device) -> torch.Tensor:
    """An array (numpy, or anything ``np.asarray`` reads) as a tensor on
    ``device``; ml_dtypes' bf16 by its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def tree_to_torch(tree: Any, device: torch.device) -> Any:
    """A reference pytree of arrays (mappings, lists, leaves; None kept) as
    the same tree of tensors on ``device``."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v, device) for v in tree]
    return _to_torch(tree, device)


def mlp_axes(n_layers: int, hidden_axis: str = "model") -> list[dict[str, tuple]]:
    """The reference's ``mlp_init`` axes: the hidden axis alternates between
    a layer's output and the next one's input."""
    out = []
    for i in range(n_layers):
        ax_in = hidden_axis if i % 2 == 1 else None
        ax_out = hidden_axis if i % 2 == 0 else None
        out.append({"w": (ax_in, ax_out), "b": (ax_out,)})
    return out


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, the reference's ``jax.nn.gelu`` default."""
    return F.gelu(x, approximate="tanh")


def normal_init(gen: torch.Generator | None, shape: Sequence[int], scale: float, *,
                dtype=torch.float32, device: torch.device | None = None) -> torch.Tensor:
    """A standard normal draw times ``scale``, drawn in fp32 on ``device``
    (the generator's) and cast to ``dtype``; on the meta device, shape and
    dtype only (``gen`` unused)."""
    if device is not None and device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    return (torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
            * scale).to(dtype)


def dense_init(gen: torch.Generator | None, d_in: int, d_out: int, *, dtype=torch.float32,
               scale: float | None = None, device: torch.device | None = None
               ) -> dict[str, torch.Tensor]:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"w": normal_init(gen, (d_in, d_out), scale, dtype=dtype, device=device)}


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].to(x.dtype)


def bias_dense_init(gen: torch.Generator | None, d_in: int, d_out: int, *, dtype=torch.float32,
                    scale: float | None = None, device: torch.device | None = None
                    ) -> dict[str, torch.Tensor]:
    p = dense_init(gen, d_in, d_out, dtype=dtype, scale=scale, device=device)
    p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def bias_dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].to(x.dtype) + params["b"].to(x.dtype)


def mlp_init(gen: torch.Generator | None, dims: Sequence[int], *, dtype=torch.float32,
             device: torch.device | None = None) -> list[dict[str, torch.Tensor]]:
    """dims = [in, h1, ..., out] -> one bias-dense layer per consecutive pair."""
    return [bias_dense_init(gen, a, b, dtype=dtype, device=device)
            for a, b in zip(dims[:-1], dims[1:])]


def mlp(params: Sequence[Params], x: torch.Tensor, *,
        act: Callable[[torch.Tensor], torch.Tensor] = F.relu,
        final_act: Callable[[torch.Tensor], torch.Tensor] | None = None) -> torch.Tensor:
    if is_dtensor(x):
        return _mlp_on_mesh(params, x, act, final_act)
    for i, p in enumerate(params):
        x = _activated(bias_dense(p, x), i, len(params), act, final_act)
    return x


def _activated(x, i: int, n: int, act, final_act):
    if i < n - 1:
        return act(x)
    return final_act(x) if final_act is not None else x


def _mlp_on_mesh(params: Sequence[Params], x, act, final_act):
    """``mlp`` of a DTensor ``x`` whose rows (dim 0) may be split, with its
    weights laid out as the reference's ``mlp_init`` lays them out
    (``mlp_axes``, divisibility-aware: ``spec_for_shape``).

    Where the rows are not split over the mesh axis that holds the hidden
    units (``model``), the layers run tensor-parallel over it, as XLA runs
    the reference's: an even layer, weight (None, model), is
    column-parallel (each rank's rows times its block of units, plus its
    bias block); an odd layer, weight (model, None), row-parallel (each
    rank's partial product, summed over ``model``, the bias added once
    after the sum, then the activation); a layer whose width ``model``
    does not divide is replicated, as ``spec_for_shape`` replicates its
    weight.  The sums are all-reduces (``comm.psum_whole``), not
    reduce-scatters: what follows each one (the next column layer, a
    replicated last layer, the caller's layernorm or residual over whole
    rows, or DLRM's interaction) needs every unit on every rank of
    ``model``; a reduce-scatter over rows would need the all-gather back
    before the next MLP, the same bytes.  A column layer takes its input
    through ``comm.pvary``, whose backward sums the input's gradient over
    ``model``, so every value replicated over ``model`` has its whole
    gradient on every rank there (``local_blocks(reduced=...)``).  The
    weights stay in their blocks, forward and backward: a block's gradient
    is partial over the row axes alone (``pod``/``data``).  The output is
    laid out as the rows, its last dimension split over ``model`` where
    the last layer is column-parallel (DLRM's bottom MLP: the caller
    gathers it).

    Where the rows are split over ``model`` too (retrieval's candidates,
    the large graphs' nodes and edges), or no layer splits, each rank runs
    its rows through the whole layers (``local_rows``)."""
    mesh = x.device_mesh
    rows = tuple(a for a, p in zip(mesh.mesh_dim_names, x.placements) if p.is_shard(0))
    specs = [spec_for_shape(ax["w"], tuple(p["w"].shape), mesh)
             for ax, p in zip(mlp_axes(len(params)), params)]
    axis = next((e for s in specs for e in s if e is not None), None)  # the hidden units' axis
    if axis is None or axis_size(axis, mesh) == 1 or set(_axes(axis)) & set(rows):
        def whole_layers(xb, *ws):
            return mlp([{"w": w, "b": b} for w, b in zip(ws[0::2], ws[1::2])], xb, act=act,
                       final_act=final_act)

        return local_rows(whole_layers, (x,), [p[k] for p in params for k in ("w", "b")])
    from repro_torch.distributed.comm import psum_whole, pvary

    def layers(xb, *ws):
        for i, ((w_in, w_out), w, b) in enumerate(zip(specs, ws[0::2], ws[1::2])):
            p = {"w": w, "b": b}
            if w_out is not None:  # column-parallel: this rank's units
                xb = bias_dense(p, pvary(xb, axis, mesh))
            elif w_in is not None:  # row-parallel: the partial products summed, then the bias
                xb = psum_whole(dense(p, xb), axis, mesh) + b.to(xb.dtype)
            else:  # replicated
                xb = bias_dense(p, xb)
            xb = _activated(xb, i, len(specs), act, final_act)
        return xb

    row_spec = (rows if len(rows) > 1 else rows[0]) if rows else None
    inputs = [(x, (row_spec,))]
    for (w_in, w_out), p in zip(specs, params):
        inputs += [(p["w"], (w_in, w_out)), (p["b"], (w_out,))]
    out_spec = (row_spec,) + (None,) * (x.dim() - 2) + (specs[-1][1],)
    return local_blocks(layers, inputs, out_spec, reduced=_axes(axis))


def rmsnorm_init(dim: int, dtype=torch.float32, device: torch.device | None = None
                 ) -> dict[str, torch.Tensor]:
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    # gemma-style (1 + scale) so zero-init is identity
    return (x * (1.0 + params["scale"].float())).to(dtype)


LAYERNORM_AXES = {"scale": (None,), "bias": (None,)}


def layernorm_init(dim: int, dtype=torch.float32, device: torch.device | None = None
                   ) -> dict[str, torch.Tensor]:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    if is_dtensor(x):  # on a mesh: each rank's rows
        return local_rows(lambda xb, scale, bias: layernorm({"scale": scale, "bias": bias}, xb,
                                                          eps=eps),
                          (x,), (params["scale"], params["bias"]))
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dtype)


def embedding_init(gen: torch.Generator, vocab: int, dim: int, *, dtype=torch.float32,
                   scale: float = 0.02) -> dict[str, torch.Tensor]:
    return {"table": torch.randn((vocab, dim), generator=gen, dtype=dtype) * scale}


def embed(params: Params, ids: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    t = params["table"]
    if compute_dtype is not None:
        t = t.to(compute_dtype)
    return t[ids]


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap
