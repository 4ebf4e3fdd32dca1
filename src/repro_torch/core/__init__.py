"""The paper's contribution in PyTorch: the learned membership model f(t, d)
(dot product or MLP head), its zero-false-negative thresholds, Algorithms
1-3, and the Eq. (2) storage-gain analysis."""
from repro_torch.core.algorithms import (
    EngineState,
    block_query,
    build_engine,
    exhaustive_query,
    run_queries,
    two_tier_guaranteed,
    two_tier_query,
)
from repro_torch.core.gain import (
    GainReport,
    LearnedStorageReport,
    estimate_gain,
    gain_curve,
    learned_storage_fractions,
    storage_fraction_curve,
)
from repro_torch.core.learned_bloom import (
    NUMERIC_MARGIN,
    LearnedBloom,
    bloom_predict,
    false_negative_rate,
    false_positive_rate,
    fit_thresholds,
)
from repro_torch.core.membership import (
    MembershipModel,
    init_membership,
    membership_loss,
    pair_logits,
    params_from_jax,
    predict,
    term_doc_logits,
)

__all__ = [
    "EngineState",
    "GainReport",
    "LearnedBloom",
    "LearnedStorageReport",
    "MembershipModel",
    "NUMERIC_MARGIN",
    "block_query",
    "bloom_predict",
    "build_engine",
    "estimate_gain",
    "exhaustive_query",
    "false_negative_rate",
    "false_positive_rate",
    "fit_thresholds",
    "gain_curve",
    "init_membership",
    "learned_storage_fractions",
    "membership_loss",
    "pair_logits",
    "params_from_jax",
    "predict",
    "run_queries",
    "storage_fraction_curve",
    "term_doc_logits",
    "two_tier_guaranteed",
    "two_tier_query",
]
