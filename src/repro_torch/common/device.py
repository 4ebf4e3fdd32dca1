"""Device selection for the port's entry points: CUDA unless the caller asks
for the CPU, and never a silent move from one to the other."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """torch.device for ``device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        # tensors report "cuda:N"; name the card so device checks compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def init_generator(seed: int | torch.Generator, device: str | torch.device = "cuda"
                   ) -> tuple[torch.Generator | None, torch.device]:
    """(generator, device) for a model's init: a generator seeded on
    ``device``, or the one given; none on the meta device, where an init
    gives shapes and dtypes only."""
    dev = torch.device(device)
    dev = dev if dev.type == "meta" else resolve_device(dev)
    if isinstance(seed, torch.Generator) or dev.type == "meta":
        return (seed if isinstance(seed, torch.Generator) else None), dev
    return torch.Generator(device=dev).manual_seed(int(seed)), dev
