"""train_step / eval_step factories: autograd gradients, gradient
accumulation over microbatches, activation checkpointing, then the AdamW
update.

``loss_fn(model, batch) -> scalar``.  The returned step updates the model's
parameters and the optimizer state in place and returns its metrics.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Mapping

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.common.config import OptimizerConfig, TrainConfig
from repro_torch.train.optimizer import AdamState, adam_update, init_adam

LossFn = Callable[[nn.Module, Mapping[str, torch.Tensor]], torch.Tensor]

# the products whose outputs the "dots" policy keeps (jax's
# checkpoint_dots_with_no_batch_dims: dot_general without batch dims)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.dot.default,
         torch.ops.aten.mv.default}


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def apply_remat(loss_fn: LossFn, policy: str) -> LossFn:
    """'none': as is; 'full': recompute every activation in the backward
    pass; 'dots': keep the matrix products' outputs, recompute the rest."""
    if policy == "none":
        return loss_fn
    if policy == "full":
        return lambda model, batch: checkpoint(loss_fn, model, batch, use_reentrant=False)
    if policy == "dots":
        return lambda model, batch: checkpoint(
            loss_fn, model, batch, use_reentrant=False,
            context_fn=partial(create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat policy {policy}")


def _laid_out_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient laid out as its parameter: DTensor may leave a
    replicated parameter's gradient partial (the data-parallel sum not yet
    taken) or sharded otherwise; the update needs the parameter's layout."""
    from torch.distributed.tensor import DTensor

    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(
    loss_fn: LossFn,
    opt_cfg: OptimizerConfig,
    train_cfg: TrainConfig | None = None,
    *,
    n_microbatches: int = 1,
):
    """Returns step(model, opt_state, batch) -> metrics.

    n_microbatches > 1 runs sequential gradient accumulation: the batch's
    leading axis splits into equal microbatches, each one's gradients add
    up in the parameters' ``.grad``, and loss and gradients are averaged
    over them (activations live one microbatch at a time)."""
    lfn = apply_remat(loss_fn, train_cfg.remat if train_cfg is not None else "none")

    def step(model: nn.Module, opt_state: AdamState, batch: Mapping[str, torch.Tensor]):
        params = [p for _, p in sorted(model.named_parameters())]
        for p in params:
            p.grad = None
        if n_microbatches == 1:
            loss = lfn(model, batch)
            loss.backward()
            loss = loss.detach()
        else:
            parts = []
            for i in range(n_microbatches):
                mb = {k: v.reshape(n_microbatches, v.shape[0] // n_microbatches, *v.shape[1:])[i]
                      for k, v in batch.items()}
                part = lfn(model, mb)
                part.backward()
                parts.append(part.detach())
            loss = sum(parts) / n_microbatches
        grads = [_laid_out_as(p.grad, p) if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if n_microbatches > 1:
            grads = [g / n_microbatches for g in grads]
        metrics = adam_update(grads, opt_state, params, opt_cfg)
        metrics["loss"] = loss
        return metrics

    return step


def make_eval_step(loss_fn: LossFn):
    """Returns eval_step(model, batch) -> the loss, without gradients."""

    @torch.no_grad()
    def eval_step(model: nn.Module, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return loss_fn(model, batch)

    return eval_step


def init_train_state(model: nn.Module, opt_cfg: OptimizerConfig) -> AdamState:
    return init_adam([p for _, p in sorted(model.named_parameters())], opt_cfg)
