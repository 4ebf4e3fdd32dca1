"""Input generators of the benchmark: collections, query mixes, embeddings.

Copies of the port's generators (``data/corpus.py``, ``data/queries.py``)
and of the seeded tables of the web-scale step, kept here so that no change
to the program changes what the benchmark feeds it.
"""
