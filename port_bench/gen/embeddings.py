"""Seeded tables of one rank of the web-scale learned index, on the device.

As the port's web-scale check makes them: f(t, d) = te[t] . de[d] is about
N(0, 1) and tau is uniform in [0.3, 0.8), so a term holds about 30% of the
documents.  Doc and term rows are bf16, as the plan stores them; tau is
fp32.  Three large calls on a generator of the device.
"""
from __future__ import annotations

import math

import torch


def learned_index_tables(n_docs: int, n_terms: int, embed: int, seed: int,
                         device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return {
        "doc_embed": torch.randn((n_docs, embed), generator=gen, device=device)
        .to(torch.bfloat16),
        "term_embed": (torch.randn((n_terms, embed), generator=gen, device=device)
                       / math.sqrt(embed)).to(torch.bfloat16),
        "tau": 0.3 + 0.5 * torch.rand(n_terms, generator=gen, device=device),
    }
