"""Mesh-distributed building blocks on ``torch.distributed``: compressed
gradient all-reduce, collective matmuls, the GPipe pipeline (``comm`` holds
the collectives over named mesh axes they run on)."""
from repro_torch.distributed.compression import (
    ErrorFeedback,
    compressed_allreduce,
    dequantize_chunk,
    quantize_chunk,
)
from repro_torch.distributed.collective_matmul import (
    collective_matmul_ag,
    matmul_reduce_scatter,
)
from repro_torch.distributed.pipeline import gpipe, make_pipeline_fn

__all__ = [
    "ErrorFeedback",
    "compressed_allreduce",
    "quantize_chunk",
    "dequantize_chunk",
    "collective_matmul_ag",
    "matmul_reduce_scatter",
    "gpipe",
    "make_pipeline_fn",
]
