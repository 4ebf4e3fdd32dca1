"""Dry-run planning over the production mesh: the part of the reference's
``launch/dryrun.py`` that the mesh slice needs.

``shardings_for`` resolves a tree of logical axes against a tree of tensor
specs on a mesh: per leaf, its divisibility-aware spec, the shape of one
rank's shard and its bytes, with no tensor allocated and no world (a
``MeshSpec`` is enough).  ``_opt_axes_like`` gives the AdamW state the
parameters' axes.

The grid dry-run itself (``dryrun_cell`` / ``run_all`` / ``main`` over all
38 cells: lower every cell's step on the 256- and 512-rank meshes and read
its memory, FLOPs and collective bytes) is not ported yet.  It needs a
partitioner: DTensor over torch's ``fake`` process-group backend under
``FakeTensorMode``, with a DTensor sharding rule for every op of every
model family.  The reference's HLO parser (``collective_bytes``) has no
counterpart; the port would count collectives with ``CommDebugMode``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, NamedTuple

import torch

from repro_torch.common.sharding import as_spec, spec_for_shape
from repro_torch.train.optimizer import AdamState, init_adam


class LeafSharding(NamedTuple):
    """One leaf's layout on a mesh."""

    spec: tuple  # divisibility-aware: mesh axis (or tuple, or None) per dim
    global_shape: tuple[int, ...]
    shard_shape: tuple[int, ...]  # one rank's block
    dtype: torch.dtype
    bytes: int  # one rank's block


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def leaf_sharding(axes: tuple, shape, dtype: torch.dtype, mesh) -> LeafSharding:
    m = as_spec(mesh)
    spec = spec_for_shape(axes, tuple(shape), m)
    local = []
    for dim, entry in zip(shape, spec):
        n = 1 if entry is None else math.prod(
            m.shape[a] for a in ((entry,) if isinstance(entry, str) else entry))
        local.append(int(dim) // n)
    local += [int(d) for d in tuple(shape)[len(spec):]]
    nbytes = math.prod(local) * torch.empty((), dtype=dtype).element_size()
    return LeafSharding(spec, tuple(int(d) for d in shape), tuple(local), dtype, nbytes)


def shardings_for(tree_axes: Any, tree_specs: Any, mesh) -> Any:
    """(logical-axes tree, spec tree) -> ``LeafSharding`` tree.

    A spec is anything with ``shape`` and ``dtype`` (a ``TensorSpec``, a
    meta tensor); the trees are mappings, lists and dataclasses (an
    ``AdamState``) of them.  Divisibility-aware: mesh axes that don't divide
    a dim fall back to replicated (e.g. MQA kv_heads=1, batch=1 decode)."""
    if _is_axes(tree_axes):
        if isinstance(tree_specs, (int, float)):  # a Python scalar (the step)
            return leaf_sharding((), (), torch.int64, mesh)
        return leaf_sharding(tree_axes, tuple(tree_specs.shape), tree_specs.dtype, mesh)
    if isinstance(tree_axes, Mapping):
        return {k: shardings_for(tree_axes[k], tree_specs[k], mesh) for k in tree_axes}
    if dataclasses.is_dataclass(tree_axes):
        return dataclasses.replace(tree_axes, **{
            f.name: shardings_for(getattr(tree_axes, f.name), getattr(tree_specs, f.name), mesh)
            for f in dataclasses.fields(tree_axes)})
    return [shardings_for(a, s, mesh) for a, s in zip(tree_axes, tree_specs, strict=True)]


def leaves(tree: Any) -> list[LeafSharding]:
    """The ``LeafSharding`` leaves of a ``shardings_for`` tree, in order."""
    if isinstance(tree, LeafSharding):
        return [tree]
    if isinstance(tree, Mapping):
        return [x for k in tree for x in leaves(tree[k])]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in leaves(getattr(tree, f.name))]
    return [x for t in tree for x in leaves(t)]


def opt_specs_like(param_specs: Mapping[str, Any], opt_cfg) -> AdamState:
    """The AdamW state of parameters with these specs, as meta tensors (the
    counterpart of ``jax.eval_shape(init_train_state)``); moments in the
    train step's parameter order, sorted by name."""
    metas = [torch.empty(tuple(param_specs[n].shape), dtype=param_specs[n].dtype, device="meta")
             for n in sorted(param_specs)]
    return init_adam(metas, opt_cfg)


def _opt_axes_like(param_axes: Mapping[str, tuple], opt_specs: AdamState) -> AdamState:
    """Optimizer-state axes: moments inherit the param's logical axes; an
    int8 moment's 'q' mirrors the param's axes exactly and its 'scale' drops
    the last axis (anything else would reshard in the Adam update)."""

    def like(ax, spec):
        if isinstance(spec, Mapping) and "q" in spec:
            return {"q": ax, "scale": tuple(ax[:-1]) + (None,)}
        return ax

    names = sorted(param_axes)
    if len(names) != len(opt_specs.m):
        raise ValueError(f"{len(names)} parameters, {len(opt_specs.m)} moments")
    return AdamState(step=(), m=[like(param_axes[n], s) for n, s in zip(names, opt_specs.m)],
                     v=[like(param_axes[n], s) for n, s in zip(names, opt_specs.v)])
