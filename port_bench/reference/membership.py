"""The web-scale step's result words, worked out with plain PyTorch.

f(t, d) = te[t] . de[d], both bf16 tables widened to fp32, summed in fp32
with TF32 off; a bit is set where f >= tau[t] for every valid (>= 0) term
of the query (a query without one matches every document); bit i of word w
is document 32 w + i.  Bits whose logit lies within NUMERIC_MARGIN
(1 + |tau|) of tau for some valid term of the query may differ between two
fp32 summation orders and are the configuration's margin.

``precision="bf16"`` rounds each logit to bfloat16 before the comparison:
the lower-precision control.
"""
from __future__ import annotations

import torch

NUMERIC_MARGIN = 1e-5
DOC_CHUNK = 1 << 18


def _slots(queries: torch.Tensor):
    valid = queries >= 0
    q_of = torch.arange(queries.shape[0], device=queries.device)[:, None].expand_as(queries)
    return valid, queries[valid].long(), q_of[valid], valid.sum(1)


def _chunks(params, queries, precision: str):
    """Yield (c0, hits (Q, C) bool, near (Q, C) bool) over doc chunks."""
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        valid, terms, q_of, n_valid = _slots(queries)
        te = params["term_embed"][terms].float()
        tau = params["tau"][terms].float()
        de = params["doc_embed"]
        n_q = queries.shape[0]
        for c0 in range(0, de.shape[0], DOC_CHUNK):
            if precision == "fp32":
                logits = te @ de[c0:c0 + DOC_CHUNK].float().T
            else:
                logits = (te.to(torch.bfloat16) @ de[c0:c0 + DOC_CHUNK].T).float()
            hit = (logits >= tau[:, None]).to(torch.int16)
            near = ((logits - tau[:, None]).abs()
                    <= NUMERIC_MARGIN * (1 + tau.abs()[:, None])).to(torch.int16)
            del logits
            c = hit.shape[1]
            hits = torch.zeros((n_q, c), dtype=torch.int16, device=de.device)
            hits.index_add_(0, q_of, hit)
            nears = torch.zeros((n_q, c), dtype=torch.int16, device=de.device)
            nears.index_add_(0, q_of, near)
            del hit, near
            yield c0, hits == n_valid[:, None].to(torch.int16), nears > 0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def unpack(words: torch.Tensor) -> torch.Tensor:
    """(Q, W) int32 words -> (Q, 32 W) bool, LSB first."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    return ((words.unsqueeze(-1) >> shifts) & 1).reshape(words.shape[0], -1).bool()


def pack(bits: torch.Tensor) -> torch.Tensor:
    """(Q, 32 W) bool -> (Q, W) int32 words, LSB first."""
    q = bits.shape[0]
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    packed = (bits.reshape(q, -1, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed).to(torch.int32)


def words(params, queries: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """(Q, D/32) int32 result words computed at ``precision``."""
    parts = [pack(hits) for _, hits, _ in _chunks(params, queries, precision)]
    return torch.cat(parts, 1)


def compare(params, queries: torch.Tensor, got: torch.Tensor) -> dict[str, int]:
    """Bits of ``got`` (on any device) that differ from the fp32 reference,
    outside and within the margin."""
    outside = within = 0
    for c0, hits, near in _chunks(params, queries, "fp32"):
        c = hits.shape[1]
        differ = unpack(got[:, c0 // 32:(c0 + c) // 32].to(hits.device)) != hits
        outside += int((differ & ~near).sum())
        within += int((differ & near).sum())
    return {"outside": outside, "within": within}
