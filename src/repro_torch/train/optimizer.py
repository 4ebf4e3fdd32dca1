"""AdamW with global-norm clipping, optional int8 moments, and the
reference's LR schedule.

The reference's ``adam_update`` written out over a model's parameters:
global-norm clip, linear warmup then cosine decay to 10%, bias-corrected
moments and decoupled weight decay.  Parameters and moments are updated in
place (the reference returns new arrays; in place saves a copy of every
table).  With ``moment_dtype="int8"`` both moments are stored as the
reference's block-quantized int8 (``quantize_blockwise``: param-shaped
int8 values and one fp32 absmax scale per 256 elements of the last axis),
dequantized for the update and quantized again after it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from repro_torch.common.config import OptimizerConfig

QBLOCK = 256


# ------------------------------------------------------------- int8 moments
def _blk(last: int) -> int:
    return min(QBLOCK, max(1, last))


def _span(off: int, n: int, last: int) -> tuple[int, int, int, int]:
    """Columns [off, off + n) of a last axis of ``last`` in blocks of
    ``_blk(last)`` -> (first block, blocks touched, zeros before, zeros
    after) that pad the span to whole blocks."""
    b = _blk(last)
    lo, hi = off // b, -(-(off + n) // b)
    return lo, hi - lo, off - lo * b, hi * b - off - n


def _quantize_span(x: torch.Tensor, off: int, last: int) -> torch.Tensor:
    """Columns [off, off + x.shape[-1]) of a global last axis of ``last``
    -> their absmax / 127 for every block of the global axis (0 for the
    blocks they do not touch): the scale where no other span shares a
    block, else this span's part of its maximum."""
    n = x.shape[-1]
    lo, nb, left, right = _span(off, n, last)
    blocks = F.pad(x, (left, right)).reshape(*x.shape[:-1], nb, _blk(last))
    part = blocks.abs().amax(-1) / 127.0  # (..., nb)
    scale = x.new_zeros((*x.shape[:-1], -(-last // _blk(last))), dtype=torch.float32)
    scale[..., lo:lo + nb] = part
    return scale


def _divide_span(x: torch.Tensor, scale: torch.Tensor, off: int, last: int) -> torch.Tensor:
    n = x.shape[-1]
    lo, nb, left, right = _span(off, n, last)
    blocks = F.pad(x, (left, right)).reshape(*x.shape[:-1], nb, _blk(last))
    q = torch.round(blocks / torch.clamp(scale[..., lo:lo + nb, None], min=1e-12))
    return q.to(torch.int8).reshape(*x.shape[:-1], nb * _blk(last))[..., left:left + n]


def _dequantize_span(q: torch.Tensor, scale: torch.Tensor, off: int, last: int) -> torch.Tensor:
    n = q.shape[-1]
    lo, nb, left, right = _span(off, n, last)
    blocks = F.pad(q, (left, right)).float().reshape(*q.shape[:-1], nb, _blk(last))
    out = blocks * scale[..., lo:lo + nb, None]
    return out.reshape(*q.shape[:-1], nb * _blk(last))[..., left:left + n]


def _last_axis_block(x) -> tuple[int, int]:
    """(offset, length) of this rank's block of a DTensor's last axis: each
    mesh dimension that shards it splits the block before it as
    ``torch.chunk`` does, outer dimension first (plain integers, so that
    it runs under ``FakeTensorMode`` too)."""
    last, coord = x.dim() - 1, x.device_mesh.get_coordinate()
    off, n = 0, int(x.shape[-1])
    for d, pl in enumerate(x.placements):
        if pl.is_shard(last):
            blk = -(-n // x.device_mesh.size(d))
            start = min(coord[d] * blk, n)
            off, n = off + start, min(n, start + blk) - start
    return off, n


def _scale_placements(x, partial: bool) -> tuple:
    """A moment's scale: the parameter's placements on every axis but the
    last; on a mesh dimension that splits the last axis, replicated (or
    partial, pending the maximum over the blocks the ranks share)."""
    from torch.distributed.tensor import Partial, Replicate

    last = x.dim() - 1
    return tuple((Partial("max") if partial else Replicate()) if pl.is_shard(last) else pl
                 for pl in x.placements)


def _quantize_dtensor(x) -> dict:
    """``quantize_blockwise`` of a DTensor, with global semantics: the blocks
    run along the global last axis, wherever the shards cut it; 'q' takes
    ``x``'s placements and 'scale' ``_scale_placements``' (the reference's
    ``_opt_axes_like``).  A block that two ranks' shards share gets the
    maximum of their absmaxes (one all-reduce over the mesh dimensions
    that split the last axis)."""
    from torch.distributed.tensor import DTensor

    mesh, last = x.device_mesh, x.shape[-1]
    off, _ = _last_axis_block(x)
    local = x.to_local()
    gshape = (*x.shape[:-1], -(-last // _blk(last)))
    stride = tuple(math.prod(gshape[d + 1:]) for d in range(len(gshape)))
    scale = DTensor.from_local(_quantize_span(local, off, last), mesh,
                               _scale_placements(x, partial=True), shape=gshape, stride=stride)
    scale = scale.redistribute(mesh, _scale_placements(x, partial=False))
    q = _divide_span(local, scale.to_local(), off, last)
    return {"q": DTensor.from_local(q, mesh, x.placements, shape=x.shape, stride=x.stride()),
            "scale": scale}


def quantize_blockwise(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """x (..., L) -> {'q': int8 (..., L), 'scale': f32 (..., ceil(L/B))},
    bit for bit the reference's: absmax / 127 per block, then x / max(scale,
    1e-12) rounded half to even.  A DTensor gives DTensors
    (``_quantize_dtensor``)."""
    from torch.distributed.tensor import DTensor

    if x.dim() == 0:
        x = x.reshape(1)
    if isinstance(x, DTensor):
        return _quantize_dtensor(x)
    last = x.shape[-1]
    scale = _quantize_span(x, 0, last)
    return {"q": _divide_span(x, scale, 0, last), "scale": scale}


def dequantize_blockwise(qs: dict[str, torch.Tensor], shape: tuple[int, ...]) -> torch.Tensor:
    """The fp32 moment of shape ``shape``; DTensor values give a DTensor laid
    out as 'q'."""
    from torch.distributed.tensor import DTensor

    q = qs["q"]
    if len(shape) == 0:
        return (q.float() * qs["scale"]).reshape(())
    if isinstance(q, DTensor):
        off, _ = _last_axis_block(q)
        out = _dequantize_span(q.to_local(), qs["scale"].to_local(), off, shape[-1])
        return DTensor.from_local(out, q.device_mesh, q.placements, shape=q.shape,
                                  stride=q.stride())
    return _dequantize_span(q, qs["scale"], 0, shape[-1])


# ------------------------------------------------------------- schedules
def lr_schedule(cfg: OptimizerConfig, step: int) -> float:
    """Linear warmup -> cosine decay to 10%."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    t = min(max((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.1 + 0.45 * (1.0 + math.cos(math.pi * t))
    return cfg.lr * warm * cos


# ------------------------------------------------------------- AdamW
@dataclass
class AdamState:
    step: int = 0
    m: list = field(default_factory=list)  # fp32 tensors, or {'q', 'scale'} dicts
    v: list = field(default_factory=list)


def init_adam(params: list[torch.Tensor], cfg: OptimizerConfig) -> AdamState:
    if cfg.moment_dtype not in ("fp32", "int8"):
        raise ValueError(f"unknown moment_dtype {cfg.moment_dtype!r}")
    if cfg.moment_dtype == "int8":
        def mk(p):  # a DTensor parameter's moments are DTensors laid out as it is
            return quantize_blockwise(torch.zeros_like(p, dtype=torch.float32))
    else:
        def mk(p):
            return torch.zeros_like(p, dtype=torch.float32)
    return AdamState(step=0, m=[mk(p) for p in params], v=[mk(p) for p in params])


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.stack([g.float().square().sum() for g in tensors]).sum().sqrt()


@torch.no_grad()
def adam_update(
    grads: list[torch.Tensor], state: AdamState, params: list[torch.Tensor], cfg: OptimizerConfig
) -> dict[str, torch.Tensor | float]:
    """Update ``params`` and ``state`` in place -> metrics."""
    state.step += 1
    step = state.step
    gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    else:
        clip = torch.ones((), device=gnorm.device)
    b1, b2 = cfg.betas
    lr = lr_schedule(cfg, step)
    c1, c2 = 1 - b1**step, 1 - b2**step
    quant = cfg.moment_dtype == "int8"
    for i, (p, g) in enumerate(zip(params, grads)):
        g = g.float() * clip
        m = dequantize_blockwise(state.m[i], tuple(p.shape)) if quant else state.m[i]
        v = dequantize_blockwise(state.v[i], tuple(p.shape)) if quant else state.v[i]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        upd = (m / c1) / ((v / c2).sqrt() + cfg.eps) + cfg.weight_decay * p.float()
        p.sub_((lr * upd).to(p.dtype))
        if quant:
            state.m[i], state.v[i] = quantize_blockwise(m), quantize_blockwise(v)
    return {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def sgd_update(grads: list[torch.Tensor], params: list[torch.Tensor], lr: float
               ) -> list[torch.Tensor]:
    """p -= lr * g for every parameter, in place -> params."""
    for p, g in zip(params, grads):
        p.sub_(lr * g.to(p.dtype))
    return params
