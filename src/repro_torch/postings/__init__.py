"""Learned-postings subsystem: rank-model codecs for sorted doc-id lists.

plm    — ε-bounded piecewise-linear model (PGM-style shrinking cone)
rmi    — two-stage recursive model index (linear root + per-leaf LS)
hybrid — per-term min-bits selection over learned + classical codecs
search — model-guided ε-window probes (guided_search kernel on the card)
"""
from repro_torch.postings.hybrid import (
    CANDIDATES,
    HybridPostings,
    choose_codec,
    hybrid_decode,
    hybrid_encode,
    hybrid_size_bits,
)
from repro_torch.postings.plm import DEFAULT_EPS, fit_segments, plm_decode, plm_encode, plm_size_bits
from repro_torch.postings.rmi import fit_rmi, rmi_decode, rmi_encode, rmi_size_bits
from repro_torch.postings.search import GuidedPostings, ProbeStats, TermModel, load_term_model

__all__ = [
    "CANDIDATES",
    "DEFAULT_EPS",
    "GuidedPostings",
    "HybridPostings",
    "ProbeStats",
    "TermModel",
    "choose_codec",
    "fit_rmi",
    "fit_segments",
    "hybrid_decode",
    "hybrid_encode",
    "hybrid_size_bits",
    "load_term_model",
    "plm_decode",
    "plm_encode",
    "plm_size_bits",
    "rmi_decode",
    "rmi_encode",
    "rmi_size_bits",
]
