"""CUDA kernel: squared interval MINDIST, the pruning scan
(``csrc/lb_paa_interval.cu``).

Replaces the TPU kernel ``repro/kernels/lb_isax.py::lb_paa_interval`` (body
``_kernel``; ``lb_isax`` is its degenerate ED case), which broadcasts a
``(TQ, TL, w)`` block in VMEM and pads node rows with ``3e9``.  On Hopper it
is an elementwise pass plus a reduction over ``w`` (≤ 16 here): bound by
the bytes of the ``[L, w]`` tables in and the ``[Q, L]`` bounds out.  Each
block stages 128 leaves (coalesced, conflict-free stride) and the intervals
of 8 queries in shared memory, each thread owns one leaf, and ragged edges
are masked in the kernel.  The per-leaf sum runs over ``j`` in order, as
the reference does, and the ``+inf`` pad leaf stays ``+inf``.
"""
from __future__ import annotations

import torch

from . import _build

#: launches of the CUDA kernel (a plain count; callers reset it to 0)
launches = 0


def lb_paa_interval(seg_lo: torch.Tensor, seg_hi: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """``seg_lo/seg_hi [Q, w]``, ``lo/hi [L, w]`` f32 on CUDA → ``[Q, L]``."""
    global launches
    _build.require_cuda("lb_paa_interval", seg_lo=(seg_lo, 2),
                        seg_hi=(seg_hi, 2), lo=(lo, 2), hi=(hi, 2))
    dev = seg_lo.device
    Q, w = seg_lo.shape
    L = lo.shape[0]
    if seg_hi.shape != (Q, w) or lo.shape[1] != w or hi.shape != (L, w):
        raise ValueError("lb_paa_interval: shape mismatch "
                         f"{[tuple(t.shape) for t in (seg_lo, seg_hi, lo, hi)]}")
    if w > 32:
        raise ValueError(f"lb_paa_interval: w={w} > 32 exceeds the kernel's "
                         f"shared-memory tile")
    out = torch.empty((Q, L), dtype=torch.float32, device=dev)
    if Q == 0 or L == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.lib().dumpy_lb_paa_interval_f32(
            seg_lo.data_ptr(), seg_hi.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            out.data_ptr(), Q, L, w, float(n / w), stream)
    _build.check(err, "lb_paa_interval")
    launches += 1
    return out

