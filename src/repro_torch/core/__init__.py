"""The paper's contribution in PyTorch: the learned membership model f(t, d),
its zero-false-negative thresholds, and Algorithms 1 and 3."""
from repro_torch.core.algorithms import EngineState, block_query, build_engine, exhaustive_query, run_queries
from repro_torch.core.learned_bloom import (
    NUMERIC_MARGIN,
    LearnedBloom,
    bloom_predict,
    false_negative_rate,
    fit_thresholds,
)
from repro_torch.core.membership import (
    MembershipModel,
    membership_loss,
    pair_logits,
    params_from_jax,
    term_doc_logits,
)

__all__ = [
    "EngineState",
    "LearnedBloom",
    "MembershipModel",
    "NUMERIC_MARGIN",
    "block_query",
    "bloom_predict",
    "build_engine",
    "exhaustive_query",
    "false_negative_rate",
    "fit_thresholds",
    "membership_loss",
    "pair_logits",
    "params_from_jax",
    "run_queries",
    "term_doc_logits",
]
