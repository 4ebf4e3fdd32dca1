from repro_torch.models import attention, moe, transformer

__all__ = ["attention", "moe", "transformer"]
