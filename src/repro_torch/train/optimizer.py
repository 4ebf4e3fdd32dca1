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


def quantize_blockwise(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """x (..., L) -> {'q': int8 (..., L), 'scale': f32 (..., ceil(L/B))},
    bit for bit the reference's: absmax / 127 per block, then x / max(scale,
    1e-12) rounded half to even."""
    if x.dim() == 0:
        x = x.reshape(1)
    last = x.shape[-1]
    b = _blk(last)
    pad = (-last) % b
    blocks = F.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, b)
    scale = blocks.abs().amax(-1) / 127.0  # (..., nblk)
    q = torch.round(blocks / torch.clamp(scale[..., None], min=1e-12)).to(torch.int8)
    q = q.reshape(*x.shape[:-1], last + pad)[..., :last]
    return {"q": q, "scale": scale.float()}


def dequantize_blockwise(qs: dict[str, torch.Tensor], shape: tuple[int, ...]) -> torch.Tensor:
    if len(shape) == 0:
        return (qs["q"].float() * qs["scale"]).reshape(())
    last = shape[-1]
    b = _blk(last)
    pad = (-last) % b
    blocks = F.pad(qs["q"], (0, pad)).float().reshape(*shape[:-1], -1, b)
    out = blocks * qs["scale"][..., None]
    return out.reshape(*shape[:-1], last + pad)[..., :last]


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
        def mk(p):
            return quantize_blockwise(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
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
