"""Tiny functional NN layer helpers shared across model families.

The reference's helpers as functions on tensors: parameters are plain
mappings of tensors (a ``dict``, or an ``nn.ParameterDict`` when a module
owns them), layers are functions.  The weight layout is the reference's,
``x @ w`` with ``w`` of shape (d_in, d_out), so its weights carry across as
copies with no transpose.  Inits draw from a seeded ``torch.Generator``
(normal x 1/sqrt(d_in) for dense weights, zero biases); the reference's
sharding-axes twin trees have no counterpart on one device.
"""
from __future__ import annotations

import math
from typing import Callable, Mapping, Sequence

import torch
import torch.nn.functional as F

Params = Mapping[str, torch.Tensor]


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


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, dtype=torch.float32,
               scale: float | None = None) -> dict[str, torch.Tensor]:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"w": torch.randn((d_in, d_out), generator=gen, dtype=dtype) * scale}


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].to(x.dtype)


def bias_dense_init(gen: torch.Generator, d_in: int, d_out: int, *, dtype=torch.float32,
                    scale: float | None = None) -> dict[str, torch.Tensor]:
    p = dense_init(gen, d_in, d_out, dtype=dtype, scale=scale)
    p["b"] = torch.zeros((d_out,), dtype=dtype)
    return p


def bias_dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].to(x.dtype) + params["b"].to(x.dtype)


def mlp_init(gen: torch.Generator, dims: Sequence[int], *, dtype=torch.float32
             ) -> list[dict[str, torch.Tensor]]:
    """dims = [in, h1, ..., out] -> one bias-dense layer per consecutive pair."""
    return [bias_dense_init(gen, a, b, dtype=dtype) for a, b in zip(dims[:-1], dims[1:])]


def mlp(params: Sequence[Params], x: torch.Tensor, *,
        act: Callable[[torch.Tensor], torch.Tensor] = F.relu,
        final_act: Callable[[torch.Tensor], torch.Tensor] | None = None) -> torch.Tensor:
    for i, p in enumerate(params):
        x = bias_dense(p, x)
        if i < len(params) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


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


def layernorm_init(dim: int, dtype=torch.float32) -> dict[str, torch.Tensor]:
    return {"scale": torch.ones((dim,), dtype=dtype), "bias": torch.zeros((dim,), dtype=dtype)}


def layernorm(params: Params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
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
