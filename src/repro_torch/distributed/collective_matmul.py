"""All-gather-overlapped matmul (collective matmul, Wang et al., MaxText).

Setting: y = x_global @ W_local where
  * x is sharded on the contraction axis k (e.g. the reduce-scattered output
    of the previous TP layer): each rank holds (m, k/N);
  * W is sharded on the output axis n: each rank holds ALL k rows for its
    n/N columns, (k, n/N).

The naive plan all-gathers x over k, THEN multiplies, and the transfer and
the products serialize.  The collective matmul rotates x shards around the
ring and accumulates one partial product per hop against the matching
k-row block of the local W: the transfer of hop i+1 is started before the
product of hop i and waited for after it.

Each rank calls these on its own blocks (inside ``shard_map``).  Both
accumulate in fp32 and cast to x's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.common.sharding import axis_index, axis_size
from repro_torch.distributed.comm import ppermute, ppermute_start


def collective_matmul_ag(
    x_shard: torch.Tensor,  # (m, k_local) — k-sharded input
    w_full_k: torch.Tensor,  # (k_global, n_local) — output-sharded weight
    axis_name: str,
    mesh=None,
) -> torch.Tensor:
    """Returns y_local = x_global @ w_full_k, shape (m, n_local)."""
    n = axis_size(axis_name, mesh)
    idx = axis_index(axis_name, mesh)
    k_local = x_shard.shape[1]
    if w_full_k.shape[0] != k_local * n:
        raise ValueError(f"w has {w_full_k.shape[0]} rows, x's shards need {k_local} x {n}")
    # send "backwards" so after i hops we hold the shard of rank idx+i
    perm = [(i, (i - 1) % n) for i in range(n)]
    acc = torch.zeros((x_shard.shape[0], w_full_k.shape[1]), dtype=torch.float32,
                      device=x_shard.device)
    shard = x_shard
    for i in range(n):
        nxt = ppermute_start(shard, axis_name, perm, mesh) if i < n - 1 else None
        origin = (idx + i) % n
        w_block = w_full_k[origin * k_local:(origin + 1) * k_local]
        acc = acc + shard.float() @ w_block.float()
        if nxt is not None:
            shard = nxt()
    return acc.to(x_shard.dtype)


def matmul_reduce_scatter(
    x_shard: torch.Tensor,  # (m, k_local) — k-sharded input
    w_k_sharded: torch.Tensor,  # (k_local, n) — k-sharded weight
    axis_name: str,
    mesh=None,
) -> torch.Tensor:
    """y_local = reduce_scatter(x @ w) over n: the dual TP pattern.

    Ring: accumulate partial products while rotating partial sums so each
    rank ends holding only its n/N output columns (wire = fp32 partials).
    """
    n = axis_size(axis_name, mesh)
    idx = axis_index(axis_name, mesh)
    full = x_shard.float() @ w_k_sharded.float()  # (m, n)
    n_local = full.shape[1] // n
    perm = [(i, (i + 1) % n) for i in range(n)]
    acc = torch.zeros((full.shape[0], n_local), dtype=torch.float32, device=full.device)
    for i in range(n - 1):
        # after hop i, acc holds the partial sum destined for rank idx+i+1
        src = (idx + n - 1 - i) % n
        acc = ppermute(acc + full[:, src * n_local:(src + 1) * n_local], axis_name, perm, mesh)
    own = full[:, idx * n_local:(idx + 1) * n_local]
    return (acc + own).to(x_shard.dtype)
