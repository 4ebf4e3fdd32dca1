from repro_torch.data.corpus import Corpus, synthesize_corpus
from repro_torch.data.loader import PrefetchLoader, lm_token_batches, membership_batches
from repro_torch.data.queries import (
    brute_force_answers,
    sample_queries,
    zipf_conjunctions,
    zipf_disjunctions,
)

__all__ = ["Corpus", "PrefetchLoader", "brute_force_answers", "lm_token_batches",
           "membership_batches", "sample_queries",
           "synthesize_corpus", "zipf_conjunctions", "zipf_disjunctions"]
