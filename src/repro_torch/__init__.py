"""PyTorch/CUDA port of the learned-index-compression system.

Mirrors the JAX reference package ``repro`` module for module.  It imports
torch and numpy only — never jax and nothing of ``repro`` — and its entry
points run on CUDA unless the caller passes ``device="cpu"``.  On the card
the serving path's hot loops run on the hand-written Hopper kernels under
``repro_torch.kernels``; on the CPU the same wrappers run their plain
PyTorch versions.
"""
