from repro_torch.data.corpus import Corpus, synthesize_corpus
from repro_torch.data.loader import membership_batches
from repro_torch.data.queries import brute_force_answers, sample_queries, zipf_conjunctions

__all__ = ["Corpus", "brute_force_answers", "membership_batches", "sample_queries",
           "synthesize_corpus", "zipf_conjunctions"]
