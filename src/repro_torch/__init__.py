"""Dumpy (compact adaptive data-series index) on PyTorch and CUDA.

The port of the JAX package ``repro`` to an NVIDIA H100, with the same
layout and names: ``core`` (host build, device layout, search),
``kernels`` (hand-written CUDA kernels behind ``kernels.ops``, each with a
plain PyTorch twin), ``serving`` (the coalescing front-end and the
kNN-softmax head), ``robustness`` and ``data``.  It imports neither
``jax`` nor ``repro``.
"""
