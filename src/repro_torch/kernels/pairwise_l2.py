"""CUDA kernel: squared-L2 distance matrix (``csrc/pairwise_l2.cu``).

Replaces the TPU kernel ``repro/kernels/pairwise_l2.py::pairwise_l2`` (body
``_kernel``), a 128×128×512-tiled MXU matmul with the norm terms fused into
the last contraction step; the reference search runs its XLA twin
``repro.core.lb.ed2_batch_jnp`` as the ED candidate slab.  At the main
path's shape (Q=64, X=chunk=2048, n=256) the work is ``2·Q·X·n`` = 67 MFLOP
over ~2.6 MB: about a microsecond of float32 FMA outside the tensor cores
(67 TFLOP/s), so a call's time is latency and how much of the card it
fills.  The design keeps float32 throughout (TF32 would reorder true
neighbours, see the source) and gives each block a 32×32 output tile: 128
blocks of 8 warps at the main shape.  Chunks of 32 columns are staged into
an 8-chunk ring of shared memory with ``cp.async``; the contraction is cut
into 4 fixed column classes (column ``c`` in class ``(c // 4) % 4``), each
summed by two warps in 4×4 register tiles from 16-byte shared reads, with
the row norms spread over all threads; the classes are added in a fixed
order, so each distance depends on its two rows alone, never on where they
sit.  ``n % 4 == 0`` with 16-byte-aligned operands takes 16-byte copies;
any other length or alignment takes 4-byte copies in the same kernel (the
same sums, the same bits).  Ragged rows and columns are zero-filled by the
copies and masked at the store; nothing is padded in device memory.
"""
from __future__ import annotations

import torch

from . import _build

#: launches of the CUDA kernel (a plain count; callers reset it to 0)
launches = 0


def pairwise_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``q [Q, n]``, ``x [X, n]`` f32 on CUDA → squared distances ``[Q, X]``."""
    global launches
    _build.require_cuda("pairwise_l2", q=(q, 2), x=(x, 2))
    if q.shape[1] != x.shape[1]:
        raise ValueError(f"pairwise_l2: lengths differ ({q.shape[1]} vs "
                         f"{x.shape[1]})")
    Q, n = q.shape
    X = x.shape[0]
    out = torch.empty((Q, X), dtype=torch.float32, device=q.device)
    if Q == 0 or X == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.lib().dumpy_pairwise_l2_f32(
            q.data_ptr(), x.data_ptr(), out.data_ptr(), Q, X, n, stream)
    _build.check(err, "pairwise_l2")
    launches += 1
    return out


def abstract(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The dry run's stand-in on fake tensors: an empty ``[Q, X]`` and the
    call's work, recorded as ``pairwise_l2``: each row read once and the
    matrix written once (bytes); ``2·Q·X·n`` for the products, ``2·(Q+X)·n``
    for the norms and 4 a distance for the epilogue (operations)."""
    Q, n = q.shape
    X = x.shape[0]
    (out,) = _build.abstract_outputs("pairwise_l2", (q, x),
                                     [((Q, X), torch.float32)])
    _build.record("pairwise_l2", 2 * Q * X * n + 2 * (Q + X) * n + 4 * Q * X,
                  4 * (Q * n + X * n + Q * X), (out,))
    return out
