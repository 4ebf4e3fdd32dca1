"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each ``kernels/<name>/`` holds ``kernel.py`` (the wrapper: checks its
inputs, launches the CUDA kernel of ``csrc/<name>.cu`` on a CUDA tensor, or
runs the plain version on a CPU tensor), ``ref.py`` (the plain version) and,
where the path needs one, ``ops.py`` (the host bridge from index structures
to the kernel's tensors).  ``kernels.cuda`` builds and loads the libraries.
"""
