"""The PAPER'S OWN system at web scale: batched conjunctive Boolean serving
over a ClueWeb09B-sized collection (|D| = 50.2M docs, 128-dim embeddings —
the paper's s=512-bit model), planned on the production mesh.

Two cells (configs/learned_index.py):
  serve_queries — Algorithm 1 exhaustive scan: 4096 queries × 8 terms against
                  ALL docs -> packed result bitmaps (doc-sharded)
  serve_block   — Algorithm 3: block-bitmap AND + scan of a fixed candidate
                  budget (64 blocks x 1024 docs per query)

``run`` reports each cell's per-rank argument shapes and bytes over the
(16, 16) or (2, 16, 16) mesh (``shardings_for``; no world, nothing
allocated).  The steps are what one rank runs on its share: on a CUDA
tensor ``exhaustive_step`` scores the Q·T slots on the ``membership``
kernel (bias 0) and ANDs them over T on the ``bitset`` kernel, and
``block_step`` takes its block AND from the ``bitset`` kernel and scores
its candidates with PyTorch ops (XLA ops in the reference); on the CPU the
kernels' plain versions run.  Semantics are the reference's: bf16
embeddings upcast to fp32, a hit is logit >= tau, pad terms (-1) act as
all-ones, words are packed LSB-first (uint32 bit patterns in int32).

  python -m repro_torch.launch.dryrun_learned_index [--multi-pod] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
from typing import Mapping

import torch

from repro_torch.kernels.bitset.kernel import block_candidates
from repro_torch.kernels.membership.kernel import membership_bitmask
from repro_torch.launch.dryrun import leaves, shardings_for
from repro_torch.launch.mesh import production_spec
from repro_torch.launch.steps import TensorSpec

N_DOCS = 50_220_423  # ClueWeb09B
N_DOCS_PAD = -(-N_DOCS // 2048) * 2048  # shardable over any mesh axis product
N_TERMS = 960_000  # scaled vocab (full ClueWeb vocab is table-sharded the same way)
EMBED = 128
Q_EXH, Q_BLK, T = 4096, 1024, 8
BLOCK_SIZE = 1024
N_BLOCKS = -(-N_DOCS_PAD // BLOCK_SIZE)
CAND_BLOCKS = 64  # per-query candidate-block budget for Algorithm 3
LANE = 32


def param_specs() -> dict[str, TensorSpec]:
    return {
        "term_embed": TensorSpec((N_TERMS, EMBED), torch.bfloat16),
        "doc_embed": TensorSpec((N_DOCS_PAD, EMBED), torch.bfloat16),
        "tau": TensorSpec((N_TERMS,), torch.float32),
    }


PARAM_AXES = {
    "term_embed": ("terms", None),
    "doc_embed": ("docs", None),
    "tau": ("terms",),
}


def cell_args(cell: str) -> tuple[dict, dict]:
    """(specs, logical axes) of a cell's arguments beside the params."""
    if cell == "serve_queries":
        return ({"queries": TensorSpec((Q_EXH, T), torch.int32)},
                {"queries": ("batch", None)})
    if cell == "serve_block":
        return ({"queries": TensorSpec((Q_BLK, T), torch.int32),
                 "block_maps": TensorSpec((N_TERMS, -(-N_BLOCKS // LANE)), torch.int32),
                 "cand_docs": TensorSpec((Q_BLK, CAND_BLOCKS * BLOCK_SIZE), torch.int32)},
                {"queries": ("batch", None), "block_maps": ("terms", None),
                 "cand_docs": ("batch", None)})
    raise ValueError(f"unknown cell {cell!r}")


def _slots(queries: torch.Tensor):
    """(valid (Q, T), term ids clamped, (Q, T) row of each valid slot or -1)."""
    valid = queries >= 0
    slot = torch.cumsum(valid.reshape(-1).to(torch.int64), 0).reshape(valid.shape) - 1
    return valid, queries.clamp(min=0).long(), torch.where(valid, slot, -1).to(torch.int32)


def exhaustive_step(params: Mapping[str, torch.Tensor], queries: torch.Tensor) -> torch.Tensor:
    """(Q, T) term ids -> (Q, D/32) packed result words (Algorithm 1 on one
    rank's doc shard): the AND over a query's valid terms of f(t, ·) >= tau."""
    de = params["doc_embed"]
    n_docs = de.shape[0]
    if n_docs % LANE:
        raise ValueError(f"{n_docs} docs do not fill words of {LANE}")
    valid, q, slot = _slots(queries)
    te = params["term_embed"][q[valid]].float()  # (R, E) the valid slots
    tau = params["tau"][q[valid]].float()
    # the bf16 doc table as it is stored: the kernel widens it on the way in
    rows = membership_bitmask(te.contiguous(), de, tau.contiguous(), 0.0)  # (R, D/32)
    words = rows.shape[1]
    # the AND over T on the bitset kernel: one all-ones block row keeps every block
    wb = -(-words // BLOCK_SIZE)
    ones = torch.full((1, wb), -1, dtype=torch.int32, device=de.device)
    terms = torch.where(valid, 0, -1).to(torch.int32)
    if rows.shape[0] == 0:
        rows = torch.full((1, words), -1, dtype=torch.int32, device=de.device)
    cand, _, _ = block_candidates(ones, terms, slot, rows, n_docs, BLOCK_SIZE)
    # a query with no valid term matches every doc, as the reference's empty AND
    return torch.where(valid.any(1, keepdim=True), cand, torch.full_like(cand, -1))


def block_and(block_maps: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(Q, W) AND of each query's block bitmaps, pad terms all-ones: the
    ``bitset`` kernel's block AND (one block a candidate word)."""
    w = block_maps.shape[1]
    words = w * LANE
    slots = torch.where(queries >= 0, 0, -1).to(torch.int32)
    ones = torch.full((1, words), -1, dtype=torch.int32, device=block_maps.device)
    _, anded, _ = block_candidates(block_maps.contiguous(), queries.to(torch.int32).contiguous(),
                                   slots, ones, words * LANE, LANE)
    return anded


def block_step(params: Mapping[str, torch.Tensor], queries: torch.Tensor,
               block_maps: torch.Tensor, cand_docs: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 3: bitmap AND -> (Q, W) words, and the fixed candidate
    budget scored with f -> (Q, C) bool (every valid term a hit)."""
    valid = queries >= 0
    q = queries.clamp(min=0).long()
    anded = block_and(block_maps, queries)
    te = params["term_embed"][q].float()  # (Q, T, E)
    tau = params["tau"][q]
    ce = params["doc_embed"][cand_docs.long()].float()  # (Q, C, E)
    logits = torch.einsum("qte,qce->qtc", te, ce)
    hits = (logits >= tau[:, :, None]) | ~valid[:, :, None]
    return anded, hits.all(dim=1)


def _record(cell: str, mesh, specs: dict, axes: dict) -> dict:
    sh = shardings_for(axes, specs, mesh)
    args = {name: {"global_shape": list(s.global_shape), "shard_shape": list(s.shard_shape),
                   "spec": [list(e) if isinstance(e, tuple) else e for e in s.spec],
                   "dtype": str(s.dtype).removeprefix("torch."), "bytes": s.bytes}
            for name, s in sh.items()}
    rec = {
        "arch": "learned-index",
        "shape": cell,
        "mesh": "x".join(str(s) for s in mesh.axis_sizes),
        "status": "ok",
        "kind": "serve",
        "n_devices": int(torch.tensor(mesh.axis_sizes).prod()),
        "args": args,
        "argument_bytes": sum(s.bytes for s in leaves(sh)),
    }
    print(f"[dryrun-li] {cell}: args/dev {rec['argument_bytes'] / 2**30:.3f} GiB "
          + " ".join(f"{n}{tuple(a['shard_shape'])}" for n, a in args.items()))
    return rec


def run(multi_pod: bool = False) -> list[dict]:
    """Per-rank argument shapes and bytes of both cells on the production mesh."""
    mesh = production_spec(multi_pod)
    results = []
    for cell in ("serve_queries", "serve_block"):
        specs, axes = cell_args(cell)
        results.append(_record(cell, mesh, {**param_specs(), **specs}, {**PARAM_AXES, **axes}))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="dryrun_learned_index.json")
    args = ap.parse_args(argv)
    res = run(args.multi_pod)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
