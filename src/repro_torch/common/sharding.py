"""Logical-axis sharding rules, MaxText-style, and their placement on a
``torch.distributed`` device mesh: the reference's ``common/sharding.py``.

Every parameter and activation is annotated with *logical* axis names; a
rules table maps logical names to mesh axes per mesh.  The rules run over a
``MeshSpec`` (a plain description of axis names and sizes, the counterpart
of the reference's ``abstract_mesh``: planning needs no world) or over a
``DeviceMesh``; a spec is a tuple with one entry a dimension: a mesh-axis
name, a tuple of names, or ``None`` (replicated).

The mesh half maps the reference's JAX pieces onto ``torch.distributed``:
``concrete_mesh`` builds a ``DeviceMesh`` over an initialised process group,
``mesh_context``/``current_mesh`` hold the ambient mesh (``jax.set_mesh`` /
``get_abstract_mesh``), ``axis_index`` is the rank's coordinate on a mesh
dimension (``lax.axis_index``), a spec becomes DTensor placements
(``Shard(d)`` / ``Replicate()`` per mesh dimension), and ``shard_map`` runs a
function on each rank's blocks of global inputs.  A tensor dimension split
over several mesh axes is split outer axis first, as JAX's
``P(("data", "model"))`` is.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import torch

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicated)
# "batch" folds pod+data so multi-pod meshes scale batch across pods.
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),  # ZeRO-3 parameter sharding axis
    "embed": ("pod", "data"),  # 2D weight sharding: d_model dim over data (FSDP)
    "model": "model",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": ("data", "model"),  # full EP: one/few experts per chip
    "seq": None,
    "seq_sharded": "model",  # SP: long-context KV sharding
    "layers": None,  # scanned-layer stack dim
    "opt_state": ("pod", "data", "model"),  # ZeRO: flat int8 moments over all
    "nodes": ("pod", "data", "model"),
    "edges": ("pod", "data", "model"),
    "nodes_sm": ("pod", "data"),  # small graphs: don't pay 256-way collectives
    "edges_sm": ("pod", "data"),
    "table_vocab": "model",  # recsys embedding tables sharded by row
    "candidates": "model",
    "blocks": ("pod", "data"),  # learned-index doc blocks
    "docs": ("pod", "data"),
    "terms": "model",
    None: None,
}

Spec = tuple  # one entry a dim: a mesh-axis name, a tuple of names, or None

# Logical axes whose mesh axes may split a dimension unevenly, as
# ``torch.chunk`` does (the first ranks take ceil(n / ranks) rows, the
# last ones fewer): embedding-table rows.  16 divides none of 25 of the 26
# Criteo vocabularies (DLRM's 96.1 GB of tables), and the reference's
# divisibility rule would replicate them on every rank; the port shards
# them (a departure from the reference's plan).
UNEVEN = frozenset({"table_vocab"})


class NamedSharding(NamedTuple):
    """A layout on a device mesh: one DTensor placement per mesh dimension
    (the counterpart of JAX's ``NamedSharding(mesh, spec)``)."""

    mesh: Any
    placements: tuple


@dataclass(frozen=True)
class MeshSpec:
    """Axis names and sizes of a device mesh, with no devices behind it."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"shape {self.axis_sizes} and names {self.axis_names} must align")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(shape: Sequence[int], names: Sequence[str]) -> MeshSpec:
    """MeshSpec((16, 16), ("data", "model")) from the reference's argument order."""
    return MeshSpec(tuple(names), tuple(int(s) for s in shape))


def concrete_mesh(shape: Sequence[int], names: Sequence[str], *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of the given shape over the initialised world, rank
    ``r`` at row-major position ``r``, its dimensions named ``names``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if len(shape) != len(names):
        raise ValueError(f"shape {tuple(shape)} and names {tuple(names)} must align")
    if not dist.is_initialized():
        raise RuntimeError("concrete_mesh: initialise the process group first")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"a {tuple(shape)} mesh needs a world of {n}, not {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


_AMBIENT: ContextVar = ContextVar("repro_torch_mesh", default=None)


@contextmanager
def mesh_context(mesh):
    """``with mesh_context(mesh):`` makes ``mesh`` the ambient mesh.  Under
    a ``DeviceMesh`` a plain tensor that meets a DTensor (a position range,
    a mask the model makes) acts as replicated on it (DTensor's
    ``implicit_replication``)."""
    token = _AMBIENT.set(mesh)
    try:
        if isinstance(mesh, MeshSpec):
            yield mesh
        else:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield mesh
    finally:
        _AMBIENT.reset(token)


def current_mesh():
    """The ambient mesh (a ``DeviceMesh`` or ``MeshSpec``), or None."""
    return _AMBIENT.get()


def as_spec(mesh) -> MeshSpec:
    """A ``MeshSpec`` of a ``DeviceMesh`` (a ``MeshSpec`` unchanged)."""
    if isinstance(mesh, MeshSpec):
        return mesh
    return MeshSpec(tuple(mesh.mesh_dim_names), tuple(int(s) for s in mesh.shape))


def mesh_size(mesh) -> int:
    return math.prod(as_spec(mesh).axis_sizes)


def _axes(axis: str | Sequence[str]) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(axis: str | Sequence[str], mesh=None) -> int:
    """Ranks along a mesh axis (or the product over several) of ``mesh``,
    the ambient mesh by default."""
    sizes = as_spec(mesh if mesh is not None else current_mesh()).shape
    return math.prod(sizes[a] for a in _axes(axis))


def axis_index(axis: str | Sequence[str], mesh=None) -> int:
    """This rank's coordinate along a mesh axis, ``lax.axis_index``; over
    several axes, their coordinates flattened outer axis first."""
    mesh = mesh if mesh is not None else current_mesh()
    coord = mesh.get_coordinate()
    names = list(mesh.mesh_dim_names)
    idx = 0
    for a in _axes(axis):
        d = names.index(a)
        idx = idx * int(mesh.shape[d]) + int(coord[d])
    return idx


def pvary(x, axis_names):
    """Marking a value as varying over axes: the identity here, where every
    rank's tensor is its own (JAX's type system needs the mark)."""
    return x


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf: Callable | None = None) -> Any:
    """Map ``fn`` over the leaves of mappings, lists and tuples (NamedTuples
    and dataclass instances kept as leaves unless ``is_leaf`` says so), with
    matching ``rest`` trees alongside."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, Mapping):
        return type(tree)((k, tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf))
                          for k in tree)
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def placements(spec: Spec, mesh) -> tuple:
    """A spec -> one DTensor placement per mesh dimension: ``Shard(d)`` on
    each mesh axis tensor dimension ``d`` is split over, ``Replicate()``
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(as_spec(mesh).axis_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        dims = [names.index(a) for a in _axes(entry)]
        if dims != sorted(dims):  # DTensor splits by mesh dimension, outer first
            raise ValueError(f"axes {entry} of {spec} must come in the mesh's order {names}")
        for a in _axes(entry):
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"mesh axis {a!r} used twice in {spec}")
            out[names.index(a)] = Shard(d)
    return tuple(out)


def resolve_axis(logical: str | None, mesh, rules: Mapping[str, Any] | None = None) -> Any:
    rules = rules or DEFAULT_RULES
    target = rules.get(logical, None)
    names = set(as_spec(mesh).axis_names)
    if target is None:
        return None
    if isinstance(target, tuple):
        present = tuple(a for a in target if a in names)
        if not present:
            return None
        return present if len(present) > 1 else present[0]
    return target if target in names else None


def spec_for_shape(
    logical_axes: Sequence[str | None],
    shape: Sequence[int],
    mesh,
    rules: Mapping[str, Any] | None = None,
) -> Spec:
    """Divisibility-aware spec: mesh axes that don't divide a dim are dropped
    (trailing-first), and a mesh axis is never used twice in one spec (the
    first dim that claims it wins) — e.g. MQA's kv_heads=1 falls back to
    replicated, and MoE ('experts','embed','mlp') keeps experts on `model`
    and drops mlp's claim.  An ``UNEVEN`` axis keeps its mesh axes where
    the dim has at least a row a rank."""
    sizes = as_spec(mesh).shape
    used: set[str] = set()
    entries: list[Any] = []
    for ax, dim in zip(logical_axes, shape):
        target = resolve_axis(ax, mesh, rules)
        if target is None:
            entries.append(None)
            continue
        t = (target,) if isinstance(target, str) else tuple(target)
        t = tuple(a for a in t if a not in used)
        while t:
            prod = 1
            for a in t:
                prod *= sizes[a]
            if dim % prod == 0 or (ax in UNEVEN and dim >= prod):
                break
            t = t[:-1]
        if not t:
            entries.append(None)
            continue
        used.update(t)
        entries.append(t if len(t) > 1 else t[0])
    return tuple(entries)


def partition_spec(
    logical_axes: Sequence[str | None],
    mesh,
    rules: Mapping[str, Any] | None = None,
) -> Spec:
    return tuple(resolve_axis(ax, mesh, rules) for ax in logical_axes)


def logical_to_sharding(
    logical_axes: Sequence[str | None],
    mesh,
    rules: Mapping[str, Any] | None = None,
) -> tuple:
    """('batch', None, 'model') -> DTensor placements over ``mesh``."""
    return placements(partition_spec(logical_axes, as_spec(mesh), rules), mesh)


def sharding_for_shape(
    logical_axes: Sequence[str | None],
    shape: Sequence[int],
    mesh,
    rules: Mapping[str, Any] | None = None,
) -> tuple:
    """Divisibility-aware placements (``spec_for_shape``'s)."""
    return placements(spec_for_shape(logical_axes, shape, as_spec(mesh), rules), mesh)


def with_sharding(x, logical_axes: Sequence[str | None], mesh):
    """Lay ``x`` out by logical axes: a DTensor is redistributed, a plain
    tensor (the same global value on every rank) distributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = logical_to_sharding(logical_axes, mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl)


def shard_module(model: torch.nn.Module, param_axes: Mapping[str, tuple], mesh, *,
                 src_data_rank: int | None = 0) -> torch.nn.Module:
    """Replace every parameter of ``model`` (the same global values on every
    rank) by a DTensor laid out by its logical axes, divisibility-aware
    (``spec_for_shape``, as the dry run places them), in place.  Rank
    ``src_data_rank``'s values are sent to the others; ``None`` keeps each
    rank's own (no communication)."""
    from torch.distributed.tensor import distribute_tensor

    for name, p in list(model.named_parameters()):
        pl = sharding_for_shape(param_axes[name], tuple(p.shape), mesh)
        owner = model.get_submodule(name.rpartition(".")[0])
        setattr(owner, name.rpartition(".")[2], torch.nn.Parameter(
            distribute_tensor(p.detach(), mesh, pl, src_data_rank=src_data_rank)))
    return model


def shard_params(params: Any, axes_tree: Any, mesh) -> Any:
    """Distribute a tree of (global) parameter tensors by a matching tree of
    logical axes -> the same tree of DTensors."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda ax, p: distribute_tensor(p, mesh, logical_to_sharding(ax, mesh)),
                    axes_tree, params, is_leaf=_is_axes)


def sharding_tree(axes_tree: Any, mesh) -> Any:
    """Logical-axes tree -> placements tree."""
    return tree_map(lambda ax: logical_to_sharding(ax, mesh), axes_tree, is_leaf=_is_axes)


def abstract_like(params: Any) -> Any:
    """A tree of tensors -> the same tree of meta tensors (shape and dtype
    only, the counterpart of ``jax.ShapeDtypeStruct``)."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), params)


def constrain(x, *logical_axes: str | None):
    """Activation sharding constraint by logical axes on the tensor's mesh:
    the identity on a plain tensor and on one rank; a DTensor is
    redistributed to the divisibility-aware placements.  The mesh is the
    DTensor's own, not the ambient one: a recompute in the backward (remat)
    may run on the autograd engine's device thread, outside any context."""
    if not is_dtensor(x) or mesh_size(x.device_mesh) <= 1:
        return x
    # redistribute even to the same placements: the backward then lays the
    # gradient out as the forward had it
    return x.redistribute(x.device_mesh, sharding_for_shape(logical_axes, tuple(x.shape),
                                                            x.device_mesh))


def pin(x):
    """The identity, whose backward lays a DTensor's gradient out as ``x``
    is laid out (DTensor may shard a gradient where a later view of it
    cannot split the dimension); the identity on a plain tensor."""
    if type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor

    return x.redistribute(x.device_mesh, x.placements) if isinstance(x, DTensor) else x


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a plain tensor answers without importing
    DTensor)."""
    if type(x) is torch.Tensor:  # the one-process path: nothing to import
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local_blocks(fn: Callable, inputs: Sequence[tuple[Any, Spec]], out_spec: Spec = (),
                 *, partial_out: bool = False, reduced: Sequence[str] = ()):
    """``fn`` of each rank's blocks: every ``(tensor, spec)`` of ``inputs``
    gives this rank's block of the tensor under ``spec`` (one entry a
    dimension: the mesh axes that split it, or None), and ``fn``'s result,
    this rank's block of the output, is laid out by ``out_spec`` (or, with
    ``partial_out``, is a whole-shaped sum of every rank's part: partial
    over the mesh axes that split the inputs).  Off a mesh (no DTensor
    among the inputs), ``fn`` of the tensors.

    A dimension of size n split r ways gives blocks of n / r where r
    divides n; where n divides r (fewer elements than ranks: MQA's one kv
    head when the query heads split r ways) rank i takes element
    i * n // r, the one its share of the work reads; any other split
    raises.  The mesh axes that split any input split the work: an input
    replicated over one of them gets a gradient partial over it (each
    rank's part of the sum), a split one its block's gradient, and DTensor
    reduces each to the input's own layout.  Over the mesh axes of
    ``reduced``, ``fn`` makes the sums itself (its collectives: the MLP's
    row-parallel layers, ``comm.psum_whole``, and ``comm.pvary`` on the
    way in), so an input replicated there gets its whole gradient, not a
    partial one.

    The blocks are local tensors (``redistribute`` -> ``to_local`` ->
    ``DTensor.from_local``): DTensor never sees ``fn``'s ops, so a product
    over flattened dimensions that the mesh splits on both sides (attention's
    (batch, heads), the experts' (batch, slots)) never reaches its rules,
    which vary between torch versions and crawl on strided shards.  Every
    split must be even."""
    tensors = [x for x, _ in inputs]
    lead = next((x for x in tensors if is_dtensor(x)), None)
    if lead is None:
        return fn(*tensors)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = lead.device_mesh
    names = list(mesh.mesh_dim_names)
    work = {a for _, spec in inputs for e in spec if e is not None for a in _axes(e)}
    every = (Replicate(),) * mesh.ndim

    def block(x, spec):
        blocks, takes = list(spec) + [None] * (x.dim() - len(spec)), []
        for d, entry in enumerate(blocks):
            if entry is None:
                continue
            n, r = int(x.shape[d]), axis_size(entry, mesh)
            if r % n == 0 and n % r:  # fewer elements than ranks: each takes its one
                takes.append((d, axis_index(entry, mesh) * n // r))
                blocks[d] = None
            elif n % r:
                raise ValueError(f"dim {d} of size {n} splits {r} ways ({spec}): "
                                 "neither in blocks nor an element a rank")
        pl = placements(blocks, mesh)
        grad = tuple(Partial() if isinstance(p, Replicate) and a in work and a not in reduced
                     else p for a, p in zip(names, pl))
        dt = x if is_dtensor(x) else DTensor.from_local(x, mesh, every)
        b = dt.redistribute(mesh, pl).to_local(grad_placements=grad)
        for d, i in takes:
            b = b.narrow(d, i, 1)
        return b

    out = fn(*(block(x, spec) for x, spec in inputs)).contiguous()
    if partial_out:
        summed = tuple(Partial() if a in work else Replicate() for a in names)
        return DTensor.from_local(out, mesh, summed, shape=out.shape, stride=out.stride())
    spec = tuple(out_spec) + (None,) * (out.dim() - len(out_spec))
    shape = tuple(n * (axis_size(e, mesh) if e is not None else 1) for n, e in zip(out.shape, spec))
    return DTensor.from_local(out, mesh, placements(spec, mesh), shape=shape,
                              stride=tuple(math.prod(shape[d + 1:]) for d in range(len(shape))))


def local_rows(fn: Callable, rows: Sequence[torch.Tensor], whole: Sequence[torch.Tensor] = (),
               *, partial_out: bool = False):
    """``local_blocks`` along dim 0 alone: ``fn(*rows, *whole)`` on each
    rank's rows, the ``rows`` tensors split alike along dim 0 (however many
    mesh dimensions split the first DTensor among them), the ``whole``
    tensors (weights, a gathered table) taken whole, and the result laid
    out as the rows (or, with ``partial_out``, partial over the mesh
    dimensions that split them).  Data parallelism over rows: DTensor's
    rules (a row dimension split by two mesh dimensions, a bias added to a
    partial sum, an index update) are not consulted."""
    lead = next((x for x in rows if is_dtensor(x)), None)
    if lead is None:
        return fn(*rows, *whole)
    axes = tuple(a for a, p in zip(lead.device_mesh.mesh_dim_names, lead.placements)
                 if p.is_shard(0)) or None
    return local_blocks(fn, [(x, (axes,)) for x in rows] + [(w, ()) for w in whole], (axes,),
                        partial_out=partial_out)


def _chunk_of(n: int, dims: Sequence[int], mesh) -> tuple[int, int]:
    """(start, size) of this rank's block of a dimension of ``n`` split over
    the mesh dimensions ``dims``, outer first, as ``torch.chunk`` splits (the
    first ranks take ceil(n / ranks), the last ones fewer)."""
    start, coord = 0, mesh.get_coordinate()
    for d in dims:
        blk = -(-n // mesh.size(d))
        first = min(coord[d] * blk, n)
        start, n = start + first, min(n, first + blk) - first
    return start, n


def _rows_at(block: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """Rows of ``block`` at block-relative ids, zeros for ids outside it."""
    n = block.shape[0]
    mine = ((at >= 0) & (at < n)).to(block.dtype)[..., None]
    return block[at.clamp(0, max(n - 1, 0))] * mine


def _add_rows(grad: torch.Tensor, at: torch.Tensor, g: torch.Tensor) -> None:
    """Scatter-add ``g``'s rows into ``grad`` (the block's n rows and a spare
    one) at block-relative ids; ids outside the block go to the spare row."""
    n = grad.shape[0] - 1
    idx = torch.where((at >= 0) & (at < n), at, n)
    grad.index_put_((idx.reshape(-1),), g.reshape(-1, g.shape[-1]).to(grad.dtype),
                    accumulate=True)


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """A rows' gradient is summed in fp32 at least (a bf16 table's rounded
    once at the end), so that a sum split over ranks and one process's
    differ by fp32 rounding alone."""
    return torch.promote_types(dtype, torch.float32)


class _Rows(torch.autograd.Function):
    """``table[ids]`` of a whole table, its gradient summed as
    ``_BlockRows`` sums it on a mesh (in ``_sum_dtype``)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        grad = torch.zeros((ctx.n + 1, g.shape[-1]), dtype=_sum_dtype(g.dtype), device=g.device)
        _add_rows(grad, ids, g)
        return grad[:ctx.n].to(g.dtype), None


class _BlockRows(torch.autograd.Function):
    """Rows of this rank's block of a table (rows ``r0`` on) at ``ids``,
    zeros for ids outside the block.

    With ``exchange`` (the process group of a mesh dimension that splits
    both the rows and the ids' dimension 0, and its size r), every rank of
    that group gathers the group's ids (integers), and in r chunks looks up
    its rows of each rank's share and reduce-scatters them back: the result
    is this rank's ids' rows, summed over that dimension, and no partial
    buffer is larger than the rank's share.  The backward is the mirror:
    the rows' gradients gathered chunk by chunk.

    The backward scatter-adds the gradient rows of the ids that fall in the
    block into a block-sized gradient, then sums it in place over ``reduce``
    (the groups of the mesh dimensions that split the ids and not the rows,
    over which the table is replicated).  No tensor of the whole batch's
    rows is built.  The sum is in fp32 at least (``_sum_dtype``) and in
    another order than one process's, so the block's gradient equals the
    one-process gradient's rows (``_Rows``) within fp32 rounding, not bit
    for bit."""

    @staticmethod
    def forward(ctx, block, ids, r0, exchange, reduce):
        ctx.r0, ctx.n, ctx.exchange, ctx.reduce = r0, block.shape[0], exchange, reduce
        if exchange is None:
            ctx.save_for_backward(ids)
            return _rows_at(block, ids - r0)
        from repro_torch.distributed.comm import all_gather_raw, reduce_scatter_raw

        group, r = exchange
        every = all_gather_raw(ids, group, r, 0)  # (r * m, ...): the group's ids
        ctx.save_for_backward(every)
        out = [reduce_scatter_raw(_rows_at(block, at - r0), group, r)
               for at in _exchange_chunks(every, r)]
        return torch.cat(out)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distributed.comm import all_gather_raw, psum_

        (ids,) = ctx.saved_tensors
        grad = torch.zeros((ctx.n + 1, g.shape[-1]), dtype=_sum_dtype(g.dtype), device=g.device)
        if ctx.exchange is None:
            _add_rows(grad, ids - ctx.r0, g)
        else:
            group, r = ctx.exchange
            at = _exchange_chunks(ids, r)
            lo = 0
            for a in at:
                hi = lo + a.shape[0] // r
                _add_rows(grad, a - ctx.r0, all_gather_raw(g[lo:hi], group, r, 0))
                lo = hi
        grad = grad[:ctx.n]
        for group in ctx.reduce:
            psum_(grad, group)
        return grad.to(g.dtype), None, None, None, None


def _exchange_chunks(every: torch.Tensor, r: int) -> list[torch.Tensor]:
    """The gathered ids of ``r`` ranks (``every``, each rank's m in turn) in
    min(r, m) chunks, chunk j holding slice j of each rank's m ids: the ids
    whose rows one reduce-scatter returns, slice j to each rank."""
    m = every.shape[0] // r
    per = every.reshape(r, m, *every.shape[1:])
    return [c.reshape(-1, *every.shape[1:]) for c in per.tensor_split(max(min(r, m), 1), dim=1)]


def take_rows(table, ids: torch.Tensor):
    """``table[ids]`` (ids in range) of a DTensor table whose rows may be
    sharded, without moving the table (of a plain table, ``_Rows``: the
    same gradient sum in one process).  The table is split by rows or
    replicated on each mesh dimension, as its logical axes (rows, None) lay
    it out.  On each mesh dimension that splits the rows:
      * where the ids are whole, each rank reads the ids that fall in its
        rows (zeros for the others): the result is partial (a sum) there;
      * where the ids' dimension 0 is split evenly too (retrieval's
        candidates), the ids stay split: each rank's result is its own
        ids' rows, laid out as the ids (``_BlockRows``' exchange; at most
        one such dimension).
    Elsewhere the result is laid out as ``ids``.  Any other layout (ids
    split on another dimension, or unevenly, where the rows are split;
    partial ids; a table split otherwise) raises.

    The table's gradient stays row-sharded: each rank scatter-adds the
    gradient rows of its ids into its block and sums the block over the
    mesh dimensions that split the ids alone (an all-reduce of the block,
    where the reference sums into the table's shard), in fp32 at least.
    It equals the one-process gradient within fp32 rounding (the sum order
    differs).
    DTensor's own rules would gather the whole table (indexing) or sum a
    gradient of the whole table (``F.embedding``)."""
    if not is_dtensor(table):
        return _Rows.apply(table, ids)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    if not all(p.is_shard(0) or p.is_replicate() for p in table.placements):
        raise ValueError(f"take_rows: a table split as {table.placements}, not by rows")
    rows = [d for d, p in enumerate(table.placements) if p.is_shard(0)]
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, (Replicate(),) * mesh.ndim)
    if any(p.is_partial() for p in ids.placements):
        raise ValueError(f"take_rows: partial ids {ids.placements}")
    # a split over one rank is none (DTensor cannot view a dimension it
    # splits, even one rank's: a history of one on a mesh of data 1)
    id_pl = tuple(Replicate() if mesh.size(d) == 1 else p for d, p in enumerate(ids.placements))
    split = [d for d in rows if not id_pl[d].is_replicate()]
    exchange = None
    if split:
        d = split[0]
        if (len(split) > 1 or not id_pl[d].is_shard(0) or ids.dim() == 0
                or int(ids.shape[0]) % math.prod(int(mesh.size(e)) for e, p in
                                                 enumerate(id_pl) if p.is_shard(0))):
            raise ValueError(f"take_rows: ids laid out {ids.placements} on a table split "
                             f"{table.placements} (ids {tuple(ids.shape)}): only dimension 0, "
                             "evenly, on one mesh dimension that splits the rows")
        exchange = (mesh.get_group(d), int(mesh.size(d)))
    reduce = [mesh.get_group(d) for d, p in enumerate(id_pl) if p.is_shard() and d not in rows]
    r0, _ = _chunk_of(int(table.shape[0]), rows, mesh)
    dim = int(table.shape[1])
    shape = (*ids.shape, dim)
    local = table.to_local(grad_placements=tuple(Shard(0) if d in rows else Replicate()
                                                 for d in range(mesh.ndim)))
    out = _BlockRows.apply(local, ids.to_local(), r0, exchange, reduce)
    placed = tuple(Partial() if d in rows and d not in split else p for d, p in enumerate(id_pl))
    return DTensor.from_local(out, mesh, placed, shape=shape,
                              stride=tuple(math.prod(shape[i + 1:]) for i in range(len(shape))))


def take_last(x, idx: torch.Tensor):
    """``x.gather(-1, idx[..., None])`` of a DTensor ``x`` whose last
    dimension may be split (vocab-sharded logits), without moving ``x``:
    each rank reads the ids that fall in its block of the last dimension
    (zeros for the others), so the result is partial (a sum) over the mesh
    dimensions that split it, laid out as ``x``'s other dimensions
    elsewhere, and ``x``'s gradient is its own block's.  DTensor's gather
    would gather ``x``'s last dimension whole, and its backward makes zeros
    of ``x``'s global shape on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh, last = x.device_mesh, x.dim() - 1
    split = [d for d, p in enumerate(x.placements) if p.is_shard(last)]
    rest = tuple(Replicate() if d in split else p for d, p in enumerate(x.placements))
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, (Replicate(),) * mesh.ndim)
    shape = (*idx.shape, 1)
    idx = idx.redistribute(mesh, rest).to_local()
    v0, n = _chunk_of(int(x.shape[last]), split, mesh)
    block = x.to_local(grad_placements=x.placements)
    at = idx.long()[..., None] - v0
    out = torch.where((at >= 0) & (at < n), block.gather(-1, at.clamp(0, max(n - 1, 0))),
                      torch.zeros((), dtype=block.dtype, device=block.device))
    return DTensor.from_local(out, mesh, tuple(Partial() if d in split else p
                                               for d, p in enumerate(rest)),
                              shape=shape, stride=tuple(math.prod(shape[i + 1:])
                                                        for i in range(len(shape))))


def _block(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of a global tensor under ``spec``."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n, i = axis_size(entry, mesh), axis_index(entry, mesh)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split {n} ways ({spec})")
        blk = x.shape[d] // n
        x = x.narrow(d, i * blk, blk)
    return x


def shard_map(fn: Callable, mesh, in_specs: Sequence[Any], out_specs: Any) -> Callable:
    """``fn`` on each rank's blocks, the reference's ``shard_map`` over
    global inputs: every argument (a tensor, or a tree of them under one
    spec) is the global value, sliced to this rank's block by its spec (a
    DTensor is redistributed to the spec's placements and gives its local
    tensor); each output is reassembled by its out spec with
    ``all_gather``, and a replicated out spec returns this rank's own
    value.

    Gradients are those of the one global function: an output's gradient
    must be the same on every rank, as its value is; a global input's is
    summed over the mesh, and a DTensor input's is partial over the mesh
    dimensions its spec replicates it on (``comm.mesh_input``,
    ``comm.mesh_output``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.distributed.comm import mesh_input, mesh_output

    def local(x, spec):
        if isinstance(x, DTensor):
            # resharded to the spec, as the reference's are (even to the same
            # placements: the backward then lays the gradient out as x is)
            want = placements(spec, mesh)
            x = x.redistribute(x.device_mesh, want)
            return x.to_local(grad_placements=tuple(
                Partial() if isinstance(p, Replicate) else p for p in want))
        if isinstance(x, torch.Tensor):
            return _block(mesh_input(x, mesh) if x.requires_grad else x, spec, mesh)
        return x

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments, {len(in_specs)} in_specs")
        blocks = [tree_map(lambda x, s=s: local(x, s), a) for a, s in zip(args, in_specs)]
        out = fn(*blocks)
        if _is_axes(out_specs):
            return tree_map(lambda y: mesh_output(y, out_specs, mesh), out)
        return tree_map(lambda y, s: mesh_output(y, s, mesh), out, out_specs)

    return run
