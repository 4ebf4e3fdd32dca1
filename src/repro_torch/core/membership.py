"""The learned membership function f(t, d) — the paper's central object.

The paper assumes a model f(t,d) ∈ {0,1} with f(t,d)=1 iff t ∈ d (Eq. 1) and
sizes its worst case as "a compressed 128 unit embedding for every document
and for every term" (s = 512 bits, §4).  ``MembershipModel`` is exactly that
family: term and doc embedding tables, a dot product and a scalar bias.  (The
reference's optional MLP head belongs to a later slice of the port.)
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import LearnedIndexConfig
from repro_torch.common.device import resolve_device


class MembershipModel(nn.Module):
    """f-logit(t, d) = <term_embed[t], doc_embed[d]> + bias."""

    def __init__(self, term_table: torch.Tensor, doc_table: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.term_embed = nn.Embedding.from_pretrained(term_table, freeze=False)
        self.doc_embed = nn.Embedding.from_pretrained(doc_table, freeze=False)
        self.bias = nn.Parameter(bias.reshape(()))

    @classmethod
    def init(
        cls, cfg: LearnedIndexConfig, n_terms: int, n_docs: int, *, seed: int = 0,
        device: torch.device | str = "cuda", scale: float = 0.02,
    ) -> "MembershipModel":
        """Random N(0, scale^2) tables from a seeded generator, zero bias."""
        if cfg.mlp_hidden:
            raise NotImplementedError("the MLP head is not ported yet")
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        te = torch.randn((n_terms, cfg.embed_dim), generator=gen) * scale
        de = torch.randn((n_docs, cfg.embed_dim), generator=gen) * scale
        return cls(te.to(device), de.to(device), torch.zeros((), device=device))

    def forward(self, terms: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
        return pair_logits(self, terms, docs)

    def slice_docs(self, lo: int, hi: int) -> "MembershipModel":
        """The model restricted to docs [lo, hi): the term table and bias are
        shared, the doc table's rows are copied."""
        return MembershipModel(
            self.term_embed.weight.detach(),
            self.doc_embed.weight.detach()[lo:hi].clone(),
            self.bias.detach(),
        )


def params_from_jax(params_np: Mapping, *, device: torch.device | str = "cuda") -> MembershipModel:
    """Build a MembershipModel from the reference's param pytree, given as
    numpy arrays: {'term_embed': {'table'}, 'doc_embed': {'table'}, 'bias'}."""
    if "mlp" in params_np:
        raise NotImplementedError("the MLP head is not ported yet")
    device = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    return MembershipModel(
        tensor(params_np["term_embed"]["table"]),
        tensor(params_np["doc_embed"]["table"]),
        tensor(params_np["bias"]),
    )


def pair_logits(model: MembershipModel, terms: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """f-logit for aligned (term, doc) id vectors — the training path."""
    te = model.term_embed(terms)
    de = model.doc_embed(docs)
    return (te * de).sum(-1) + model.bias


def term_doc_logits(
    model: MembershipModel, terms: torch.Tensor, doc_tile: torch.Tensor | None = None
) -> torch.Tensor:
    """Logits of f(t, ·) for every doc (or a doc-id tile): (Q, D) matmul in
    full fp32.  The serving path computes the same function thresholded and
    bit-packed in one kernel (kernels/membership)."""
    te = model.term_embed(terms)
    dt = model.doc_embed.weight if doc_tile is None else model.doc_embed(doc_tile)
    return te @ dt.T + model.bias


def membership_loss(model: MembershipModel, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Weighted BCE; positives upweighted so the zero-FN threshold stays tight."""
    logits = pair_logits(model, batch["terms"], batch["docs"])
    labels = batch["labels"]
    per = -(labels * F.logsigmoid(logits) + (1 - labels) * F.logsigmoid(-logits))
    w = torch.where(labels > 0.5, 2.0, 1.0)
    return (per * w).sum() / w.sum()
