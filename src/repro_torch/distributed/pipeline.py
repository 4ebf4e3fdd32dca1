"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis.

Each rank on the ``pipe`` axis owns one stage's params (a stacked tree,
leading axis = stage, sharded over ``pipe``).  Microbatches stream through
the ring: at tick t, stage s processes microbatch t-s and forwards its
activations with ``ppermute``.  Bubble fraction = (S-1)/(M+S-1), the GPipe
schedule.

This is the framework's PP building block; the LM archs default to TP+DP
(+EP), and the pipeline path is there for scaling across hosts where the
link between them makes TP across them impractical.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.common.sharding import axis_index, shard_map, tree_map
from repro_torch.distributed.comm import group_of, ppermute, psum


def _flatten(tree: Any) -> list:
    leaves: list = []
    tree_map(leaves.append, tree)
    return leaves


def _unflatten(tree: Any, leaves: list) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


class _GPipe(torch.autograd.Function):
    """The schedule as one autograd node.  The forward keeps each active
    tick's stage graph; the backward runs the ticks in reverse, every rank
    one inverse ``ppermute`` a tick, so the backward's transfers meet as
    the forward's did (a stage that is idle at a tick still sends zeros)."""

    @staticmethod
    def forward(ctx, plan, microbatches, *leaves):
        stage_fn, tree, n_stages, axis_name, mesh = plan
        s_idx = axis_index(axis_name, mesh)
        m = microbatches.shape[0]
        perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
        grads = [ctx.needs_input_grad[1], *ctx.needs_input_grad[2:]]
        keep = any(grads)
        params = [p.detach().requires_grad_(g) for p, g in zip(leaves, grads[1:])]
        stage_params = _unflatten(tree, params)
        outputs = torch.zeros_like(microbatches)
        prev = torch.zeros_like(microbatches[0])
        saved = {}  # tick -> (stage input, stage output) with its graph
        for t in range(m + n_stages - 1):
            # stage 0 reads microbatch t (clipped); the others the forwarded acts
            x = microbatches[min(max(t, 0), m - 1)] if s_idx == 0 else prev
            if 0 <= t - s_idx < m:
                with torch.enable_grad():
                    x = x.detach().requires_grad_(keep)
                    y = stage_fn(stage_params, x)
                if keep:
                    saved[t] = (x, y)
                y = y.detach()
            else:
                y = torch.zeros_like(prev)
            prev = ppermute(y, axis_name, perm, mesh)
            # the last stage emits microbatch t-(S-1) at tick t
            out_ix = t - (n_stages - 1)
            if s_idx == n_stages - 1 and out_ix >= 0:
                outputs[out_ix] = y
        ctx.plan, ctx.saved, ctx.params, ctx.m = plan, saved, params, m
        mask = 1.0 if s_idx == n_stages - 1 else 0.0
        return psum(outputs * mask, axis_name, mesh)

    @staticmethod
    def backward(ctx, g_out):
        _, _, n_stages, axis_name, mesh = ctx.plan
        s_idx = axis_index(axis_name, mesh)
        m = ctx.m
        inverse = [((i + 1) % n_stages, i) for i in range(n_stages)]
        g_out = psum(g_out.contiguous(), axis_name, mesh)  # the transpose of the psum
        g_mb = torch.zeros_like(g_out)
        g_params = [torch.zeros_like(p) if p.requires_grad else None for p in ctx.params]
        g_prev = torch.zeros_like(g_out[0])  # gradient of the input at tick t + 1
        for t in reversed(range(m + n_stages - 1)):
            g_y = ppermute(g_prev, axis_name, inverse, mesh)
            out_ix = t - (n_stages - 1)
            if s_idx == n_stages - 1 and out_ix >= 0:
                g_y = g_y + g_out[out_ix]
            g_prev = torch.zeros_like(g_prev)
            if t in ctx.saved:
                x, y = ctx.saved.pop(t)
                want = [x] + [p for p in ctx.params if p.requires_grad]
                got = iter(torch.autograd.grad(y, want, g_y, allow_unused=True))
                g_x = next(got)
                for i, p in enumerate(ctx.params):
                    g_p = next(got) if p.requires_grad else None
                    if g_p is not None:
                        g_params[i] += g_p
                if g_x is not None and s_idx == 0:
                    g_mb[t] += g_x
                elif g_x is not None:
                    g_prev = g_x
        return (None, g_mb if ctx.needs_input_grad[1] else None, *g_params)


def gpipe(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    n_stages: int,
    axis_name: str = "pipe",
    mesh=None,
):
    """Returns fn(stage_params_local, microbatches) for each rank to call
    on its own stage's params.

    microbatches: (M, mb, ...), the same on every rank; stage 0 consumes it.
    Output: (M, mb, ...), the last stage's, on every rank (a ``psum`` of the
    outputs masked to the last stage).  A stage runs ``stage_fn`` only at
    the ticks where it holds a microbatch: what the others would compute
    never reaches an output.  Differentiable in the microbatches and the
    stage params, by the reverse schedule.
    """

    def run(stage_params, microbatches):
        group_of(axis_name, mesh)  # made here, in the forward, if it is new
        leaves = _flatten(stage_params)
        plan = (stage_fn, stage_params, n_stages, axis_name, mesh)
        return _GPipe.apply(plan, microbatches, *leaves)

    return run


def make_pipeline_fn(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh,
    n_stages: int,
    axis_name: str = "pipe",
):
    """``shard_map`` wrapper: stacked stage params (S, ...) -> pipelined forward."""
    inner = gpipe(stage_fn, n_stages, axis_name, mesh)

    def with_squeeze(stage_params, microbatches):
        # shard_map leaves a leading stage axis of size 1 on each rank
        return inner(tree_map(lambda a: a[0], stage_params), microbatches)

    return shard_map(with_squeeze, mesh, in_specs=((axis_name,), ()), out_specs=())
