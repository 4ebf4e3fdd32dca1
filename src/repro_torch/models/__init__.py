from repro_torch.models import attention, gnn, moe, recsys, sampler, transformer

__all__ = ["attention", "gnn", "moe", "recsys", "sampler", "transformer"]
