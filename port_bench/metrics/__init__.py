"""Metric readers, one module each, named as the metric is in BENCHMARK.json.

``read(rec)`` takes a run's record (``drivers/*``: the window, set-up's
stages, the system's footprint, and with ``--trace 1`` the spans, the
profile or nvidia-smi's samples) and returns the metric's value, or None
where the record holds nothing to read.
"""
