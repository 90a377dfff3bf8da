"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

``ops`` dispatches: a CUDA tensor goes to the kernel, a CPU tensor to the
twin in ``ref``.  The kernels build on first use (``_build``).
"""
