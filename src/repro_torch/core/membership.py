"""The learned membership function f(t, d) — the paper's central object.

The paper assumes a model f(t,d) ∈ {0,1} with f(t,d)=1 iff t ∈ d (Eq. 1) and
sizes its worst case as "a compressed 128 unit embedding for every document
and for every term" (s = 512 bits, §4).  ``MembershipModel`` is that family:
term and doc embedding tables, a scalar bias, and either a dot product or,
with ``LearnedIndexConfig.mlp_hidden``, the reference's MLP head over the
concatenated pair (bias-dense layers of dims [2E, *mlp_hidden, 1], the
reference's layout ``x @ w``, tanh-approximate GELU between them).

The head's first layer is computed split, ``te @ W1[:E] + (de @ W1[E:] +
b1)``: the term side per scored term, the doc side once per model
(``doc_side``).  The serving kernel (kernels/mlp_membership) adds the same
two halves, so the threshold fit and the serving path agree to a few ulp,
inside NUMERIC_MARGIN.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common import nn as fnn
from repro_torch.common.config import LearnedIndexConfig
from repro_torch.common.device import resolve_device


class MembershipModel(nn.Module):
    """f-logit(t, d) = <term_embed[t], doc_embed[d]> + bias, or, with a head,
    mlp([term_embed[t], doc_embed[d]])[0] + bias."""

    def __init__(self, term_table: torch.Tensor, doc_table: torch.Tensor, bias: torch.Tensor,
                 mlp: Sequence[Mapping[str, torch.Tensor]] | None = None):
        super().__init__()
        self.term_embed = nn.Embedding.from_pretrained(term_table, freeze=False)
        self.doc_embed = nn.Embedding.from_pretrained(doc_table, freeze=False)
        self.bias = nn.Parameter(bias.reshape(()))
        self.mlp = nn.ModuleList(
            nn.ParameterDict({"w": nn.Parameter(layer["w"]), "b": nn.Parameter(layer["b"])})
            for layer in mlp) if mlp else None
        self._doc_side = None  # (parameter versions, doc-side tables) for serving

    @classmethod
    def init(cls, cfg: LearnedIndexConfig, n_terms: int, n_docs: int, *, seed: int = 0,
             device: torch.device | str = "cuda", scale: float = 0.02) -> "MembershipModel":
        return init_membership(cfg, n_terms, n_docs, seed=seed, device=device, scale=scale)

    def forward(self, terms: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
        return pair_logits(self, terms, docs)

    def head_layers(self) -> list[dict[str, torch.Tensor]]:
        """The head's layers as detached {'w', 'b'} tensors ([] without one)."""
        return [{"w": p["w"].detach(), "b": p["b"].detach()} for p in self.mlp or ()]

    def slice_docs(self, lo: int, hi: int) -> "MembershipModel":
        """The model restricted to docs [lo, hi): the term table, bias and
        head are shared, the doc table's rows are copied."""
        return MembershipModel(
            self.term_embed.weight.detach(),
            self.doc_embed.weight.detach()[lo:hi].clone(),
            self.bias.detach(),
            self.head_layers(),
        )

    @torch.no_grad()
    def term_side(self, terms: torch.Tensor) -> torch.Tensor:
        """(S,) term ids -> (S, H1) first-layer term halves te[terms] @ W1[:E]."""
        e = self.term_embed.weight.shape[1]
        return self.term_embed.weight[terms] @ self.mlp[0]["w"][:e]

    @torch.no_grad()
    def doc_side(self) -> tuple[torch.Tensor, torch.Tensor, tuple[int, ...]]:
        """-> (Bd, later, dims): the (D, H1) doc halves doc_embed @ W1[E:] +
        b1, the layers after the first packed flat (each w row-major, then
        its b) and their dims (H1, ..., 1).  Computed once per model and
        device and reused until a parameter changes (a training step, a
        move)."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._doc_side is None or self._doc_side[0] != key:
            self._doc_side = None  # drop the old tables before making new ones
            e = self.doc_embed.weight.shape[1]
            w1, b1 = self.mlp[0]["w"], self.mlp[0]["b"]
            bd = (self.doc_embed.weight @ w1[e:] + b1).contiguous()
            layers = self.head_layers()[1:]
            later = torch.cat([t.reshape(-1) for p in layers for t in (p["w"], p["b"])])
            dims = (int(w1.shape[1]), *(int(p["w"].shape[1]) for p in layers))
            self._doc_side = (key, (bd, later.float().contiguous(), dims))
        return self._doc_side[1]


def init_membership(
    cfg: LearnedIndexConfig, n_terms: int, n_docs: int, *, seed: int = 0,
    device: torch.device | str = "cuda", scale: float = 0.02,
) -> MembershipModel:
    """Random N(0, scale^2) tables, zero bias and, with ``cfg.mlp_hidden``,
    a head of bias-dense layers (normal x 1/sqrt(d_in), zero biases), all
    drawn from one seeded generator."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    te = fnn.embedding_init(gen, n_terms, cfg.embed_dim, scale=scale)["table"]
    de = fnn.embedding_init(gen, n_docs, cfg.embed_dim, scale=scale)["table"]
    mlp = None
    if cfg.mlp_hidden:
        dims = [2 * cfg.embed_dim, *cfg.mlp_hidden, 1]
        mlp = [{k: v.to(device) for k, v in p.items()} for p in fnn.mlp_init(gen, dims)]
    return MembershipModel(te.to(device), de.to(device), torch.zeros((), device=device), mlp)


def params_from_jax(params_np: Mapping, *, device: torch.device | str = "cuda") -> MembershipModel:
    """Build a MembershipModel from the reference's param pytree, given as
    numpy arrays: {'term_embed': {'table'}, 'doc_embed': {'table'}, 'bias'}
    and, for a head, 'mlp': [{'w', 'b'}, ...]."""
    device = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    mlp = [{"w": tensor(p["w"]), "b": tensor(p["b"])} for p in params_np.get("mlp", ())]
    return MembershipModel(
        tensor(params_np["term_embed"]["table"]),
        tensor(params_np["doc_embed"]["table"]),
        tensor(params_np["bias"]),
        mlp,
    )


def head_logits(model: MembershipModel, first: torch.Tensor) -> torch.Tensor:
    """The head after its first layer's pre-activations ``first`` (..., H1)
    -> (...) logits: GELU, the later bias-dense layers, + bias."""
    x = fnn.mlp(model.mlp[1:], fnn.gelu(first), act=fnn.gelu)
    return x[..., 0] + model.bias


def pair_logits(model: MembershipModel, terms: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """f-logit for aligned (term, doc) id vectors — the training path."""
    te = model.term_embed(terms)
    de = model.doc_embed(docs)
    if model.mlp is not None:
        e = te.shape[-1]
        w1, b1 = model.mlp[0]["w"], model.mlp[0]["b"]
        return head_logits(model, te @ w1[:e] + (de @ w1[e:] + b1))
    return (te * de).sum(-1) + model.bias


def term_doc_logits(
    model: MembershipModel, terms: torch.Tensor, doc_tile: torch.Tensor | None = None
) -> torch.Tensor:
    """Logits of f(t, ·) for every doc (or a doc-id tile): (Q, D) in full
    fp32.  A dot-product model is one matmul; a head broadcasts the
    (Q, D, H1) pairing, viable only on doc tiles.  The serving path
    computes the same functions thresholded and bit-packed in one kernel
    (kernels/membership, kernels/mlp_membership)."""
    te = model.term_embed(terms)
    dt = model.doc_embed.weight if doc_tile is None else model.doc_embed(doc_tile)
    if model.mlp is not None:
        e = te.shape[-1]
        w1, b1 = model.mlp[0]["w"], model.mlp[0]["b"]
        return head_logits(model, (te @ w1[:e])[:, None, :] + (dt @ w1[e:] + b1)[None, :, :])
    return te @ dt.T + model.bias


def membership_loss(model: MembershipModel, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Weighted BCE; positives upweighted so the zero-FN threshold stays tight."""
    logits = pair_logits(model, batch["terms"], batch["docs"])
    labels = batch["labels"]
    per = -(labels * F.logsigmoid(logits) + (1 - labels) * F.logsigmoid(-logits))
    w = torch.where(labels > 0.5, 2.0, 1.0)
    return (per * w).sum() / w.sum()


def predict(model: MembershipModel, terms: torch.Tensor, docs: torch.Tensor,
            threshold: float = 0.0) -> torch.Tensor:
    return pair_logits(model, terms, docs) >= threshold
