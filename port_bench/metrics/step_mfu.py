"""The step's share of the card's bf16 dense peak over the window: the model
operations (2·E a scored (slot, doc) pair) of the batches completed inside
the window over window seconds x 989 TFLOP/s."""
import torch

from port_bench.roofline import peak_flops


def read(rec):
    if "completed" not in rec or "kernel_s" not in rec:
        return None
    flops = sum(w["flops"] for w in rec["completed"])
    return 100.0 * flops / (rec["window_s"] * peak_flops(torch.bfloat16))
