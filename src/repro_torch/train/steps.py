"""train_step factory: autograd gradients, then the AdamW update."""
from __future__ import annotations

from typing import Callable, Mapping

import torch
from torch import nn

from repro_torch.common.config import OptimizerConfig
from repro_torch.train.optimizer import AdamState, adam_update, init_adam


def make_train_step(
    loss_fn: Callable[[nn.Module, Mapping[str, torch.Tensor]], torch.Tensor],
    opt_cfg: OptimizerConfig,
):
    """Returns step(model, opt_state, batch) -> metrics; the model's
    parameters and the optimizer state are updated in place."""

    def step(model: nn.Module, opt_state: AdamState, batch: Mapping[str, torch.Tensor]):
        params = [p for _, p in sorted(model.named_parameters())]
        for p in params:
            p.grad = None
        loss = loss_fn(model, batch)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        metrics = adam_update(grads, opt_state, params, opt_cfg)
        metrics["loss"] = loss.detach()
        return metrics

    return step


def init_train_state(model: nn.Module, opt_cfg: OptimizerConfig) -> AdamState:
    return init_adam([p for _, p in sorted(model.named_parameters())], opt_cfg)
