"""Collectives over named mesh axes: the counterparts of
``jax.lax.ppermute``, ``all_to_all`` and ``psum`` (and the ``all_gather``
that reassembles ``shard_map`` outputs) on ``torch.distributed``.

An axis is one mesh dimension's name or a tuple of names; a tuple is one
group of the ranks that share every other coordinate, ordered outer axis
first (``("data", "model")`` is data-major, the reference's device order,
on which ``moe_a2a``'s buckets depend).  Positions in ``ppermute``'s pairs
are positions in that order.

The host transport.  Gloo moves only CPU tensors for point-to-point and
all-to-all, and NCCL refuses two ranks on one device, so a world of several
ranks on one card runs gloo.  Where the group's backend is gloo and a tensor
is on the card, every helper here copies it to host memory, runs the
collective there and copies the result back, adding the bytes it moved
(both ways) to ``HOST.bytes``.  The backend is the one the caller gave
``init_process_group``; nothing here picks or switches it.
"""
from __future__ import annotations

import math
import os
import tempfile
import time
from datetime import timedelta
from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.common.sharding import current_mesh


class HostTransport:
    """Bytes the gloo path copied between the card and host memory."""

    def __init__(self):
        self.bytes = 0
        self.calls = 0

    def reset(self) -> None:
        self.bytes = 0
        self.calls = 0


HOST = HostTransport()

_GROUPS: dict = {}  # (mesh, axes) -> (group, global ranks in group order)


def _axes(axis: str | Sequence[str]) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def group_of(axis: str | Sequence[str], mesh=None):
    """(process group, its global ranks in axis order) of this rank's group
    along ``axis``.  A group over several axes is made (collectively, by
    every rank) on first use."""
    mesh = mesh if mesh is not None else current_mesh()
    axes = _axes(axis)
    names = list(mesh.mesh_dim_names)
    if len(axes) == 1:
        g = mesh.get_group(axes[0])
        return g, dist.get_process_group_ranks(g)
    key = (mesh, axes)
    if key not in _GROUPS:
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"axes {axes} must come in the mesh's order {tuple(names)}")
        rest = [d for d in range(len(names)) if d not in dims]
        # move the group's axes last and flatten them, outer axis first: the
        # mesh's rank table is bookkeeping, worked out with every dispatch
        # mode off (a dry run's fake tensors have no values)
        with _disable_current_modes():
            n = math.prod(int(mesh.mesh.shape[d]) for d in dims)
            table = mesh.mesh.permute(*rest, *dims).reshape(-1, n)
        me = dist.get_rank()
        for row in table.tolist():
            if row != sorted(row):  # a group's ranks are numbered in sorted order
                raise ValueError(f"mesh positions {row} along {axes} are not ascending ranks")
            g = dist.new_group(row)  # every rank creates every group, in one order
            if me in row:
                _GROUPS[key] = (g, row)
    return _GROUPS[key]


def _host(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _out(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the collective will read it: on the host for gloo."""
    if x.is_cuda and _host(group):
        HOST.bytes += x.numel() * x.element_size()
        HOST.calls += 1
        return x.detach().cpu()
    return x.detach().contiguous()


def _back(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_cuda and not y.is_cuda:
        HOST.bytes += y.numel() * y.element_size()
        return y.to(like.device)
    return y


def _ppermute_raw(x: torch.Tensor, group, ranks, perm) -> Callable[[], torch.Tensor]:
    me = ranks.index(dist.get_rank())
    if (me, me) in perm:  # a one-rank ring keeps its own value
        y = x.detach().clone()
        return lambda: y
    send = [d for s, d in perm if s == me]
    recv = [s for s, d in perm if d == me]
    buf = _out(x, group)
    out = torch.zeros_like(buf)
    ops = [dist.P2POp(dist.isend, buf, ranks[d], group) for d in send]
    ops += [dist.P2POp(dist.irecv, out, ranks[s], group) for s in recv]
    works = dist.batch_isend_irecv(ops) if ops else []

    def finish() -> torch.Tensor:
        for w in works:
            w.wait()
        return _back(out, x)

    return finish


def _all_to_all_raw(x: torch.Tensor, group) -> torch.Tensor:
    buf = _out(x, group)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return _back(out, x)


def all_gather_raw(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """Every rank's ``x`` over ``group`` (of ``n`` ranks), concatenated on
    ``dim`` in group order (no gradient)."""
    buf = _out(x, group)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    return _back(torch.cat(parts, dim=dim), x)


def reduce_scatter_raw(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, block i of dim 0 to
    position i (no gradient)."""
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of size {x.shape[0]} does not split {n} ways")
    buf = _out(x, group)
    out = buf.new_empty((buf.shape[0] // n, *buf.shape[1:]))
    dist.reduce_scatter_tensor(out, buf, group=group)
    return _back(out, x)


def psum_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` (contiguous) over ``group`` in place (no gradient)."""
    if x.is_cuda and _host(group):
        buf = _out(x, group)
        dist.all_reduce(buf, group=group)
        x.copy_(_back(buf, x))
    else:
        dist.all_reduce(x, group=group)
    return x


def _psum_raw(x: torch.Tensor, group) -> torch.Tensor:
    buf = _out(x, group)
    if buf.device == x.device:  # not copied to the host: reduce a copy, never x
        buf = buf.clone()
    dist.all_reduce(buf, group=group)
    return _back(buf, x)


# Gradients.  Every rank differentiates its own part of one SPMD program,
# and a rank's gradient is its contribution to the whole one: the
# transpose of ``psum`` is ``psum``, of ``all_to_all`` the same
# ``all_to_all``, of ``ppermute`` the inverse permutation, of
# ``all_gather`` a ``psum`` and this rank's block (``shard_map`` seeds
# and sums these contributions at its boundary).  Every rank must record
# the same collectives, in the same order, so that the backward's
# collectives meet: a collective whose input needs no gradient on one rank
# must need none on every rank.
class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, finish, group, ranks, perm):
        ctx.comm = (group, ranks, [(d, s) for s, d in perm])
        return finish()

    @staticmethod
    def backward(ctx, g):
        group, ranks, inverse = ctx.comm
        return _ppermute_raw(g.contiguous(), group, ranks, inverse)(), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_raw(g.contiguous(), ctx.group), None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _psum_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return _psum_raw(g.contiguous(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.comm = (group, n, dim, x.shape[dim])
        return all_gather_raw(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, dim, blk = ctx.comm
        me = dist.get_group_rank(group, dist.get_rank())
        return _psum_raw(g.contiguous(), group).narrow(dim, me * blk, blk), None, None, None


class _Vary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum_raw(g.contiguous(), ctx.group), None


class _PSumWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _psum_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Assemble(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, gathers, scale):
        ctx.comm = (gathers, scale, [])
        for group, n, dim in gathers:
            ctx.comm[2].append(y.shape[dim])
            y = all_gather_raw(y, group, n, dim)
        return y

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        if isinstance(g, DTensor):  # the output met DTensors: their gradient, whole
            g = g.full_tensor()
        gathers, scale, blocks = ctx.comm
        for (group, _, dim), blk in zip(reversed(gathers), reversed(blocks)):
            me = dist.get_group_rank(group, dist.get_rank())
            g = g.narrow(dim, me * blk, blk)
        return g * scale, None, None


def mesh_input(x: torch.Tensor, mesh) -> torch.Tensor:
    """A global tensor as ``shard_map`` takes it in: the identity, whose
    gradient is the sum over the mesh of every rank's contribution (the
    transpose of handing every rank the same value)."""
    return pvary(x, tuple(mesh.mesh_dim_names), mesh)


def mesh_output(y: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's block ``y`` of a ``shard_map`` output -> the global value,
    gathered along each dimension ``spec`` names mesh axes for.  The global
    value is the same on every rank, and so must its gradient be: each rank
    takes its own block of it, divided by the ranks that hold that block
    (they are summed again where the inputs are)."""
    gathers = []
    n_held = 1
    for dim, entry in enumerate(spec):
        if entry is not None:
            group, ranks = group_of(entry, mesh)
            gathers.append((group, len(ranks), dim))
            n_held *= len(ranks)
    world = math.prod(int(s) for s in mesh.shape)
    return _Assemble.apply(y, gathers, n_held / world)


def ppermute_start(x: torch.Tensor, axis: str | Sequence[str],
                   perm: Sequence[tuple[int, int]], mesh=None) -> Callable[[], torch.Tensor]:
    """Start ``ppermute`` and return the function that waits for it, so
    that work between the two overlaps the transfer."""
    group, ranks = group_of(axis, mesh)
    finish = _ppermute_raw(x, group, ranks, perm)
    return lambda: _PPermute.apply(x, finish, group, ranks, list(perm))


def ppermute(x: torch.Tensor, axis: str | Sequence[str], perm: Sequence[tuple[int, int]],
             mesh=None) -> torch.Tensor:
    """Send ``x`` to ``dst`` for each ``(src, dst)`` pair with this rank's
    position as ``src``; return what arrives from the pair with it as
    ``dst`` (zeros where none does, as ``lax.ppermute``)."""
    return ppermute_start(x, axis, perm, mesh)()


def all_to_all(x: torch.Tensor, axis: str | Sequence[str], mesh=None) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0, tiled=True)``: block ``i`` of dim 0
    goes to position ``i``; block ``j`` of the result came from ``j``."""
    group, ranks = group_of(axis, mesh)
    if x.shape[0] % len(ranks):
        raise ValueError(f"dim 0 of size {x.shape[0]} does not split {len(ranks)} ways")
    return _AllToAll.apply(x, group)


def psum(x: torch.Tensor, axis: str | Sequence[str], mesh=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``."""
    group, _ = group_of(axis, mesh)
    return _PSum.apply(x, group)


def pvary(x: torch.Tensor, axis: str | Sequence[str], mesh=None) -> torch.Tensor:
    """The identity, whose gradient is summed over ``axis`` (``lax.pvary``):
    a value every rank of ``axis`` holds whole, going into work each rank
    does on its own share, gets back its whole gradient on every rank."""
    group, _ = group_of(axis, mesh)
    return _Vary.apply(x, group)


def psum_whole(x: torch.Tensor, axis: str | Sequence[str], mesh=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``, held whole by each of them,
    whose gradient passes through unchanged (``psum`` under ``shard_map``'s
    replication types): every rank has the sum's whole gradient, not a
    contribution to it, as ``pvary`` leaves it.  ``psum`` is the other
    convention, a rank's gradient its contribution."""
    group, _ = group_of(axis, mesh)
    return _PSumWhole.apply(x, group)


def all_gather(x: torch.Tensor, axis: str | Sequence[str], dim: int = 0, mesh=None
               ) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on ``dim`` in axis
    order."""
    group, ranks = group_of(axis, mesh)
    return _AllGather.apply(x, group, len(ranks), dim)


def host_collectives():
    """A dispatch mode under which DTensor's functional collectives of a CUDA
    tensor, but the all-reduce, run on a host copy and come back (the host
    transport for DTensor on a gloo world on one card: gloo's
    ``all_gather_into_tensor`` of a CUDA tensor faults), the bytes added to
    ``HOST.bytes``.  Use it as ``with host_collectives():`` around DTensor
    work on such a world; DTensor-level ops pass through to DTensor, whose
    local collectives come back through the mode."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    c10d = torch.ops._c10d_functional
    moved = {c10d.all_gather_into_tensor.default, c10d.reduce_scatter_tensor.default,
             c10d.all_to_all_single.default}

    class HostCollectives(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if func not in moved or not args[0].is_cuda:
                return func(*args, **kwargs)
            x = args[0]
            HOST.bytes += x.numel() * x.element_size()
            HOST.calls += 1
            y = c10d.wait_tensor.default(func(x.detach().cpu(), *args[1:], **kwargs))
            HOST.bytes += y.numel() * y.element_size()
            return y.to(x.device)  # complete: its wait_tensor finds no work and returns it

    return HostCollectives()


def _entry(rank: int, fn: Callable, world: int, backend: str, store: str, timeout_s: float,
           args: tuple) -> None:
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, world: int, *args, backend: str, timeout_s: float = 600.0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in one process group of ``backend`` (a file store in a temporary
    directory, no port).  ``fn`` must be importable (a module-level
    function); it reports through files.  Raises if a rank raises, and
    kills the world past ``timeout_s``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(_entry, args=(fn, world, backend, os.path.join(d, "store"),
                                               timeout_s, args),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                for proc in ctx.processes:
                    proc.join()
                raise TimeoutError(f"world of {world} still running after {timeout_s} s")
