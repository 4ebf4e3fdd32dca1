"""AdamW with global-norm clipping and the reference's LR schedule.

The reference's ``adam_update`` written out over a model's parameters:
global-norm clip, linear warmup then cosine decay to 10%, bias-corrected
fp32 moments and decoupled weight decay.  Parameters and moments are
updated in place (the reference returns new arrays; in place saves a copy
of every table).  int8 moments wait for a later slice of the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from repro_torch.common.config import OptimizerConfig


def lr_schedule(cfg: OptimizerConfig, step: int) -> float:
    """Linear warmup -> cosine decay to 10%."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    t = min(max((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.1 + 0.45 * (1.0 + math.cos(math.pi * t))
    return cfg.lr * warm * cos


@dataclass
class AdamState:
    step: int = 0
    m: list[torch.Tensor] = field(default_factory=list)
    v: list[torch.Tensor] = field(default_factory=list)


def init_adam(params: list[torch.Tensor], cfg: OptimizerConfig) -> AdamState:
    if cfg.moment_dtype != "fp32":
        raise NotImplementedError(f"moment_dtype={cfg.moment_dtype!r} is not ported yet")
    return AdamState(
        step=0,
        m=[torch.zeros_like(p, dtype=torch.float32) for p in params],
        v=[torch.zeros_like(p, dtype=torch.float32) for p in params],
    )


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
    for p, g, m, v in zip(params, grads, state.m, state.v):
        g = g.float() * clip
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        upd = (m / c1) / ((v / c2).sqrt() + cfg.eps) + cfg.weight_decay * p.float()
        p.sub_((lr * upd).to(p.dtype))
    return {"grad_norm": gnorm, "lr": lr}
