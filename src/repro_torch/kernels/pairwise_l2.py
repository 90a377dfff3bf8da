"""CUDA kernel: squared-L2 distance matrix (``csrc/pairwise_l2.cu``).

Replaces the TPU kernel ``repro/kernels/pairwise_l2.py::pairwise_l2`` (body
``_kernel``), a 128×128×512-tiled MXU matmul with the norm terms fused into
the last contraction step; the reference search runs its XLA twin
``repro.core.lb.ed2_batch_jnp`` as the ED candidate slab.  At the main
path's shape (Q=64, X=chunk=2048, n=256) the work is ``2·Q·X·n`` = 67 MFLOP
over ~2.6 MB, so on Hopper it is bound by float32 FMA throughput outside
the tensor cores (67 TFLOP/s), not by memory.  The design keeps float32
throughout (TF32 would reorder true neighbours, see the source), tiles
32×64×16 in shared memory with a 4×4 register tile per thread, sums the row
norms from the same tiles in the same pass, and masks ragged rows and
columns in the kernel instead of padding in device memory.
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
