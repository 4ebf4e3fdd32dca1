"""Multi-pod dry-run: every (arch x shape x mesh) cell's step on one rank
of the production mesh, with no world and no card memory.

  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.json] [--jobs 8]
  python -m repro_torch.launch.dryrun --compare REF.json PORT.json [PORT.json ...]
  (``--compare``: the reference's ``--all --out`` results beside the port's,
  per cell: its argument + output + temp bytes, each port peak and ratio;
  its FLOPs a rank, each port's and the ratio, none for the LM cells, whose
  reference counts one scan body.)
  (``--device cpu`` builds a CPU mesh of fake CPU tensors; the default is
  fake ``cuda`` tensors, which needs a CUDA runtime but no card memory.)

The reference lowers and compiles each cell with XLA over 256 (512) host
devices and reads XLA's analyses.  The port has no compiler; for each cell
it:
  * initialises a fake process group (``FakeStore``, backend ``fake``) of
    256 or 512 ranks, as this rank (0), and destroys it after the cell;
  * builds the production ``DeviceMesh`` (``launch/mesh.py:mesh_config``);
  * under ``FakeTensorMode`` builds the cell's model (``init_fn``), shards
    it by the cell's logical axes (``shard_module``), places the inputs by
    ``input_axes`` and the optimizer state by ``_opt_axes_like``: DTensors
    whose local blocks are fake tensors, with no storage behind them;
  * runs the cell's step once on them: forward, backward and the AdamW
    update for ``train`` cells, the step itself for ``prefill``,
    ``decode``, ``serve`` and ``retrieval`` cells.  DTensor turns every op
    into this rank's local ops and the collectives its sharding rules (or
    the model's explicit redistributions) need; those are what is counted.

Output keys, as the reference's, and what each means here:
  status       ok / skipped (a documented skip of ``get_arch``) / error
  kind, n_devices   the cell's step kind; the mesh's ranks
  lower_s      seconds to build, shard and place the fake model, inputs and
               optimizer state (the reference: to lower)
  compile_s    seconds of the fake step (the reference: to compile)
  flops_per_device  one rank's FLOPs: its LOCAL ops counted by
               ``FlopCounterMode``'s registry and convention (matmuls,
               convolutions, attention; 2 FLOPs a multiply-add, no
               elementwise op), not XLA's ``cost_analysis`` convention.  A
               ``FlopCounterMode`` around DTensor ops counts the GLOBAL ops
               (the DTensor-level shapes); this counts below DTensor.
  bytes_per_device  one rank's bytes read and written by those local ops:
               each tensor argument read once and each output written once,
               per op, views, metadata ops and collectives excluded
  collective_bytes_per_device  output bytes a rank of each collective kind
               (``all-gather``, ``all-reduce``, ``reduce-scatter``,
               ``all-to-all``, ``collective-permute``), recorded by a
               dispatch mode over the functional and c10d collectives; the
               reference parses them from the optimized HLO, and there is
               no HLO here, so its parser ``collective_bytes`` has no
               counterpart
  memory       argument_bytes: one rank's bytes of parameters, optimizer
               state and inputs, the sum of ``shardings_for``'s leaf bytes;
               output_bytes: of what the step returns, and for a train step
               also of the parameters and optimizer state it updates in
               place (the reference returns them); alias_bytes: the part of
               output_bytes held in the arguments' storage (the reference's
               donated buffers); temp_bytes: the peak less argument_bytes,
               the peak taken by ``MemTracker`` over the step on the fake
               tensors (storage bytes, rounded up to 512 on ``cuda`` as the
               caching allocator does); code_bytes: 0, nothing is compiled
  largest_collectives  (the port's own) the three largest collectives, each
               with the aten op that caused it and where in the port
A cell fails (``error``) if a collective yields a whole row-sharded
embedding table or expert stack (a parameter whose ``table_vocab``,
``vocab`` or ``experts`` axis is sharded): such a fallback "runs" but voids
the plan.

The planning half needs no world at all: ``shardings_for`` resolves a
tree of logical axes against a tree of tensor specs on a mesh (per leaf,
its divisibility-aware spec, the shape of one rank's shard and its bytes;
a ``MeshSpec`` is enough) and ``_opt_axes_like`` gives the AdamW state the
parameters' axes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Mapping, NamedTuple

import torch

from repro_torch.common.sharding import as_spec, spec_for_shape
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.train.optimizer import AdamState, init_adam


class LeafSharding(NamedTuple):
    """One leaf's layout on a mesh."""

    spec: tuple  # divisibility-aware: mesh axis (or tuple, or None) per dim
    global_shape: tuple[int, ...]
    shard_shape: tuple[int, ...]  # rank 0's block (the largest, where a split is uneven)
    dtype: torch.dtype
    bytes: int  # rank 0's block


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def leaf_sharding(axes: tuple, shape, dtype: torch.dtype, mesh) -> LeafSharding:
    m = as_spec(mesh)
    spec = spec_for_shape(axes, tuple(shape), m)
    local = []
    for dim, entry in zip(shape, spec):
        n = 1 if entry is None else math.prod(
            m.shape[a] for a in ((entry,) if isinstance(entry, str) else entry))
        local.append(-(-int(dim) // n))  # torch.chunk's first block
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
        if isinstance(tree_specs, (int, float)):  # the step: the reference's int32 counter
            return leaf_sharding((), (), torch.int32, mesh)
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


# ------------------------------------------------------------ the grid dry-run
_COLLECTIVES = {  # op name -> the reference's collective kind
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "recv_": "collective-permute", "broadcast": "broadcast", "broadcast_": "broadcast",
}
_NO_COST = {"detach", "alias", "lift_fresh", "empty", "empty_strided", "empty_like",
            "wait_tensor", "send", "_local_scalar_dense"}
_SIZE_OPS = {"sym_is_contiguous", "is_contiguous", "is_strides_like_format",
             "is_non_overlapping_and_dense", "size", "sym_size", "stride", "sym_stride",
             "storage_offset", "sym_storage_offset", "numel", "sym_numel", "dim", "layout",
             "device"}
_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, Mapping):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _where() -> str:
    """The innermost frame of the port (this module aside) on the stack."""
    for f in reversed(traceback.extract_stack()):
        if f.filename.startswith(_PORT) and not f.filename.endswith("dryrun.py"):
            return f"{os.path.relpath(f.filename, _PORT)}:{f.lineno} ({f.name})"
    return "?"


def _rank_ops_mode():
    """A dispatch mode that counts one rank's local work under DTensor (built
    in a function: the mode class needs torch's dispatch machinery)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class RankOps(TorchDispatchMode):
        """Counts the ops that reach it below DTensor: a DTensor op returns
        NotImplemented here, so DTensor turns it into this rank's local ops
        and collectives first, which come back through the mode.  FLOPs as
        ``FlopCounterMode`` counts them (its registry, its decompositions);
        bytes of every other op's tensors; output bytes of collectives."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.collectives: dict[str, int] = defaultdict(int)
            self.events: list[dict] = []
            self._op = "?"  # the last DTensor-level op: what a collective serves

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                self._op = str(func)
                return NotImplemented
            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **kwargs)
            name = func._opname
            if name in _SIZE_OPS:
                return NotImplemented
            if func not in flop_registry:
                with self:
                    r = func.decompose(*args, **kwargs)
                    if r is not NotImplemented:
                        return r
            out = func(*args, **kwargs)
            packet = func._overloadpacket
            kind = _COLLECTIVES.get(name)
            if kind is not None:  # a c10d op writes its first argument; a functional one returns
                moved = _tensors(args[0] if name.endswith("_") else out)
                b = _nbytes(moved)
                self.collectives[kind] += b
                self.events.append({
                    "kind": kind, "bytes": b, "shape": [list(t.shape) for t in moved],
                    "op": self._op, "where": _where(),
                    "backward": torch._C._current_graph_task_id() != -1})
            elif packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
                self.bytes += _nbytes(_tensors(args) + _tensors(kwargs) + _tensors(out))
            elif not func.is_view and name not in _NO_COST:
                self.bytes += _nbytes(_tensors(args) + _tensors(kwargs) + _tensors(out))
            return out

    return RankOps()


@contextmanager
def fake_world(n_ranks: int, rank: int = 0):
    """A fake process group of ``n_ranks`` ranks (no transport: collectives
    return at once), this process being ``rank``, with DTensor patched for
    fake tensors (``_fake_world_patches``); destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("dry-run: a default process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n_ranks)
    try:
        with _fake_world_patches():
            yield
    finally:
        dist.destroy_process_group()


@contextmanager
def _fake_world_patches():
    """DTensor internals, patched for the dry run's duration:
      * it infers an op's output shapes by running the op on fake tensors of
        the GLOBAL shapes, under the fake mode it finds active: that run is
        not this rank's work, and runs with every dispatch mode off (the
        counters and ``MemTracker`` do not see it; it makes a fake mode of
        its own);
      * it works out a strided shard's offsets (and a local block's) with
        small index tensors that it reads back, and under ``FakeTensorMode``
        those have no values: those computations run with every dispatch
        mode off, on real CPU tensors, uncounted;
      * on a CPU mesh it reshards one dimension to another by all-gather
        and chunk (gloo has no all-to-all); a fake world has no transport,
        so it takes the all-to-all a card's mesh takes, and a CPU dry run
        counts what a ``cuda`` one counts."""
    from torch.distributed.tensor import _utils, placement_types
    from torch.distributed.tensor._collective_utils import funcol
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import _disable_current_modes

    def plain(fn):
        def run(*args, **kwargs):
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return run

    def alltoall(fn):
        def run(input, gather_dim, shard_dim, mesh, mesh_dim):
            if mesh.device_type != "cpu":  # the card's mesh takes it already
                return fn(input, gather_dim, shard_dim, mesh, mesh_dim)
            group = funcol._resolve_group((mesh, mesh_dim))
            return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                         funcol._group_or_group_name(group))
        return run

    targets = {(ShardingPropagator, "_propagate_tensor_meta_non_cached"): plain,
               (_utils, "_compute_local_shape_and_global_offset"): plain,
               (_StridedShard, "local_shard_size_and_offset"): plain,
               (placement_types, "shard_dim_alltoall"): alltoall}
    saved = {key: getattr(*key) for key in targets}
    for (owner, name), wrap in targets.items():
        setattr(owner, name, wrap(saved[(owner, name)]))
    try:
        yield
    finally:
        for (owner, name), fn in saved.items():
            setattr(owner, name, fn)


def _contiguous(shape) -> tuple[int, ...]:
    return tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))


def _place(spec, axes, mesh, device):
    """A DTensor of ``spec``'s global shape laid out by ``axes``, its block
    an uninitialised (fake) tensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.common.sharding import sharding_for_shape

    pl = sharding_for_shape(axes, tuple(spec.shape), mesh)
    local = leaf_sharding(axes, tuple(spec.shape), spec.dtype, mesh).shard_shape
    return DTensor.from_local(torch.empty(local, dtype=spec.dtype, device=device), mesh, pl,
                              shape=torch.Size(spec.shape), stride=_contiguous(spec.shape))


def _place_tree(specs, axes, mesh, device):
    from repro_torch.launch.steps import TensorSpec

    if isinstance(specs, TensorSpec):
        return _place(specs, axes, mesh, device)
    if isinstance(specs, Mapping):
        return {k: _place_tree(specs[k], axes[k], mesh, device) for k in specs}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):  # a KVCache
        return type(specs)(*(_place_tree(s, a, mesh, device) for s, a in zip(specs, axes)))
    return [_place_tree(s, a, mesh, device) for s, a in zip(specs, axes)]


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _storages(ts) -> set[int]:
    return {id(_local(t).untyped_storage()) for t in ts}


def _whole_params(model, param_axes) -> dict[tuple, str]:
    """{global shape: name} of the parameters whose ``table_vocab``,
    ``vocab`` or ``experts`` axis the mesh shards: row-sharded embedding
    tables (and the LM head), expert stacks."""
    out = {}
    blocks = {tuple(p.to_local().shape) for p in model.parameters()}
    for name, p in model.named_parameters():
        ax = param_axes[name]
        for d, a in enumerate(ax):
            if a in ("table_vocab", "vocab", "experts") and any(pl.is_shard(d)
                                                                 for pl in p.placements):
                out[tuple(p.shape)] = name
    # a shape that is also some parameter's block names that block's own
    # collective (a sharded gradient's data-parallel sum), not a whole one
    return {shape: name for shape, name in out.items() if shape not in blocks}


def _peak_tracker():
    from torch.distributed._tools.mem_tracker import MemTracker

    return MemTracker()


def _dryrun_bundle(cell, mesh, *, device: str = "cuda") -> dict[str, Any]:
    """The body of ``dryrun_cell``: ``cell``'s step once on one rank of
    ``mesh`` (a ``DeviceMesh`` over a ``fake_world``), on fake tensors ->
    the result keys from ``kind`` on."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.common.sharding import mesh_context, shard_module

    spec = as_spec(mesh)
    t0 = time.perf_counter()
    fake = FakeTensorMode()
    with fake:
        model = cell.init_fn(0, device)
        shard_module(model, cell.param_axes, mesh, src_data_rank=None)
        inputs = _place_tree(cell.input_specs, cell.input_axes, mesh, device)
        params = [p for _, p in sorted(model.named_parameters())]
        opt = init_adam(params, cell.opt_cfg) if cell.kind == "train" else None
    args = list(params) + _tensors(inputs) + (_tensors([opt.m, opt.v]) if opt else [])
    plan = leaves(shardings_for(cell.param_axes, cell.param_specs, spec))
    plan += leaves(shardings_for(cell.input_axes, cell.input_specs, spec))
    if opt is not None:
        opt_specs = opt_specs_like(cell.param_specs, cell.opt_cfg)
        plan += leaves(shardings_for(_opt_axes_like(cell.param_axes, opt_specs), opt_specs, spec))
    argument_bytes = sum(leaf.bytes for leaf in plan)
    placed = _nbytes([_local(t) for t in args]) + (4 if opt is not None else 0)
    if placed != argument_bytes:  # the placement and the plan must agree
        raise AssertionError(f"placed {placed} bytes a rank, planned {argument_bytes}")
    whole = _whole_params(model, cell.param_axes)
    t_lower = time.perf_counter() - t0

    ops, mem = _rank_ops_mode(), _peak_tracker()
    with fake:
        mem.track_external(*[_local(t) for t in args])
        with mem, ops, mesh_context(mesh):
            if cell.kind == "train":
                out = cell.step(model, opt, inputs)
            elif cell.kind == "prefill":
                out = cell.step(model, inputs["tokens"])
            elif cell.kind == "decode":
                out = cell.step(model, inputs["token"], inputs["pos"], inputs["caches"])
            else:  # serve / retrieval
                out = cell.step(model, inputs)
    t_step = time.perf_counter() - t0 - t_lower
    peak = max(mem.get_tracker_snapshot("peak").get(torch.device(d), {}).get("Total", 0)
               for d in {str(_local(t).device) for t in args})

    for e in ops.events:
        for shape in e["shape"]:
            if tuple(shape) in whole:
                raise RuntimeError(f"{e['kind']} of the whole {whole[tuple(shape)]} "
                                   f"{tuple(shape)} at {e['op']} ({e['where']})")
    returned = _tensors(out)
    outputs = returned + (args[:len(params)] + _tensors([opt.m, opt.v]) if opt else [])
    arg_storages = _storages(args)
    output_bytes = _nbytes([_local(t) for t in outputs])
    alias_bytes = _nbytes([_local(t) for t in outputs if id(_local(t).untyped_storage())
                           in arg_storages])
    largest = sorted(ops.events, key=lambda e: -e["bytes"])[:3]
    for e in largest:
        e["calls"] = sum(x["where"] == e["where"] and x["op"] == e["op"] for x in ops.events)
    return {
        "kind": cell.kind,
        "n_devices": int(math.prod(spec.axis_sizes)),
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_step, 1),
        "flops_per_device": float(ops.flops),
        "bytes_per_device": float(ops.bytes),
        "collective_bytes_per_device": dict(ops.collectives),
        "memory": {
            "argument_bytes": int(argument_bytes),
            "output_bytes": int(output_bytes),
            "temp_bytes": int(max(peak - argument_bytes, 0)),
            "alias_bytes": int(alias_bytes),
            "code_bytes": 0,
        },
        "peak_bytes": int(peak),
        "largest_collectives": largest,
    }


def _production_mesh(multi_pod: bool, device: str):
    from repro_torch.launch.mesh import mesh_config
    from repro_torch.common.sharding import concrete_mesh

    cfg = mesh_config(multi_pod)
    return concrete_mesh(cfg.shape, cfg.axes, device_type=torch.device(device).type)


def dryrun_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
                device: str = "cuda") -> dict[str, Any]:
    """One cell of the grid on one rank of the 16x16 (2x16x16) mesh; see the
    module docstring for the keys."""
    from repro_torch.launch.mesh import mesh_config
    from repro_torch.launch.steps import build_cell

    cfg, shapes, skips = get_arch(arch_id)
    if shape_name in skips:
        return {"arch": arch_id, "shape": shape_name, "status": "skipped",
                "reason": skips[shape_name]}
    shape = next(s for s in shapes if s.name == shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    with fake_world(mesh_config(multi_pod).n_devices):
        res = _dryrun_bundle(build_cell(cfg, shape), _production_mesh(multi_pod, device),
                             device=device)
    result = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name, "status": "ok", **res}
    mem = result["memory"]
    print(f"[dryrun] {arch_id} x {shape_name} x {mesh_name}: OK "
          f"(lower {result['lower_s']:.0f}s, step {result['compile_s']:.0f}s, "
          f"flops/dev {result['flops_per_device']:.3g}, "
          f"peak/dev {(mem['argument_bytes'] + mem['temp_bytes']) / 2**30:.2f} GiB)", flush=True)
    return result


def _cell_or_error(arch_id: str, shape_name: str, multi_pod: bool, device: str) -> dict:
    try:
        return dryrun_cell(arch_id, shape_name, multi_pod=multi_pod, device=device)
    except Exception as e:  # a failing cell is a bug: surface it loudly
        traceback.print_exc()
        return {"arch": arch_id, "shape": shape_name,
                "mesh": "2x16x16" if multi_pod else "16x16",
                "status": "error", "error": f"{type(e).__name__}: {e}"}


def run_all(arch_ids, *, multi_pod: bool, out_path: str | None, device: str = "cuda",
            jobs: int = 1) -> list[dict]:
    """Every (arch, shape) cell of ``arch_ids``; with ``jobs`` > 1, that many
    cells at a time, each in a fresh process (each initialises its own fake
    world).  Results in grid order, written to ``out_path`` as they come."""
    cells = [(a, s.name) for a in arch_ids for s in get_arch(a)[1]]
    results: list[dict | None] = [None] * len(cells)

    def save():
        if out_path:
            with open(out_path, "w") as f:
                json.dump([r for r in results if r is not None], f, indent=1)

    if jobs <= 1:
        for i, (a, s) in enumerate(cells):
            results[i] = _cell_or_error(a, s, multi_pod, device)
            save()
    else:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(jobs, mp_context=mp.get_context("spawn"),
                                 max_tasks_per_child=1) as pool:
            futs = [pool.submit(_cell_or_error, a, s, multi_pod, device) for a, s in cells]
            for i, f in enumerate(futs):
                results[i] = f.result()
                save()
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\n[dryrun] {n_ok} ok / {n_skip} documented skips / {n_err} errors")
    return results


SCAN_NOTE = "reference counts one scan body"


def _scans_layers(arch: str) -> bool:
    """Whether the reference scans ``arch``'s layers (``lax.scan``, the LM
    family): XLA's ``cost_analysis`` counts a scan body once, so its FLOPs
    a rank are those of one layer's, not comparable with the port's."""
    try:
        return get_arch(arch)[0].family == "lm"
    except KeyError:
        return False


def compare(ref: list[dict], *ports: list[dict]) -> list[dict]:
    """Each ``ok`` cell of the reference's ``--all`` results beside the
    port's: the reference's per-device plan (XLA's argument + output + temp
    bytes) and each port run's ``peak_bytes`` with its ratio to that plan;
    the reference's FLOPs a rank and each port run's with their ratio, but
    where the reference scans its layers (``flops_note``: its count is one
    scan body's, so no ratio)."""
    by_cell = [{(r["arch"], r["shape"]): r for r in p} for p in ports]
    rows = []
    for r in ref:
        if r["status"] != "ok":
            continue
        plan = sum(r["memory"][k] for k in ("argument_bytes", "output_bytes", "temp_bytes"))
        flops = r.get("flops_per_device")
        note = SCAN_NOTE if _scans_layers(r["arch"]) else None
        row = {"arch": r["arch"], "shape": r["shape"], "reference_bytes": plan,
               "reference_flops": flops, "flops_note": note, "port": []}
        for cells in by_cell:
            got = cells.get((r["arch"], r["shape"]), {})
            peak, port_flops = got.get("peak_bytes"), got.get("flops_per_device")
            row["port"].append({
                "peak_bytes": peak, "ratio": None if peak is None else round(peak / plan, 2),
                "flops": port_flops,
                "flops_ratio": (None if note or port_flops is None or not flops
                                else round(port_flops / flops, 2))})
        rows.append(row)
    return rows


def _compare_line(row: dict) -> str:
    """One ``--compare`` line: bytes, then FLOPs a rank."""
    peaks = " ".join(f"{p['peak_bytes']:,} ({p['ratio']}x)" if p["peak_bytes"] is not None
                     else "-" for p in row["port"])
    ref = row["reference_flops"]
    flops = " ".join("-" if p["flops"] is None else
                     f"{p['flops']:.4g}" + ("" if p["flops_ratio"] is None
                                            else f" ({p['flops_ratio']}x)")
                     for p in row["port"])
    tail = f" [{row['flops_note']}]" if row["flops_note"] else ""
    return (f"{row['arch']} {row['shape']} {row['reference_bytes']:,} {peaks} | flops "
            f"{'-' if ref is None else f'{ref:.4g}'} {flops}{tail}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="fake tensors' device: cuda or cpu")
    ap.add_argument("--jobs", type=int, default=1, help="cells at a time (--all)")
    ap.add_argument("--compare", nargs="+", metavar="JSON",
                    help="REF PORT [PORT ...]: the reference's --all results beside the "
                         "port's, per cell (no run)")
    args = ap.parse_args(argv)
    if args.compare:
        ref, *ports = [json.load(open(f)) for f in args.compare]
        for row in compare(ref, *ports):
            print(_compare_line(row))
        return
    if args.all:
        results = run_all(ARCH_IDS, multi_pod=args.multi_pod, out_path=args.out,
                          device=args.device, jobs=args.jobs)
        sys.exit(1 if any(r["status"] == "error" for r in results) else 0)
    res = _cell_or_error(args.arch, args.shape, args.multi_pod, args.device)
    print(json.dumps(res, indent=1))
    if args.out:  # as ``--all`` writes it: a list of results
        with open(args.out, "w") as f:
            json.dump([res], f, indent=1)
    sys.exit(1 if res["status"] == "error" else 0)


if __name__ == "__main__":
    main()
