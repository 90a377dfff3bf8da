"""CUDA kernel: squared interval MINDIST, the pruning scan
(``csrc/lb_paa_interval.cu``).

Replaces the TPU kernel ``repro/kernels/lb_isax.py::lb_paa_interval`` (body
``_kernel``; ``lb_isax`` is its degenerate ED case), which broadcasts a
``(TQ, TL, w)`` block in VMEM and pads node rows with ``3e9``.  On Hopper it
is six instructions an element (the product is rounded before the add) over
``[Q, L, w]``: below one launch at the search's ``[64, 757, 16]``, bound by
its arithmetic at a large collection's leaf table.  Each thread keeps a
leaf's rows in registers and sums four queries' intervals against them at
once, read from shared memory as broadcasts; the grid is sized to fill the
card's SMs; any ``w`` runs (8 and 16 compiled, others in streamed chunks of
16 columns).  Each bound is summed over ``j`` in order, exactly as an
in-order loop of separate operations, and the ``+inf`` pad leaf stays
``+inf``.
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


def abstract(seg_lo: torch.Tensor, seg_hi: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor, n: int) -> torch.Tensor:
    """The dry run's stand-in on fake tensors: an empty ``[Q, L]`` and the
    call's work, recorded as ``lb_paa_interval``: the four tables read once
    and the bounds written once (bytes); seven operations an element of
    ``[Q, L, w]`` and the scale (operations)."""
    Q, w = seg_lo.shape
    L = lo.shape[0]
    (out,) = _build.abstract_outputs("lb_paa_interval",
                                     (seg_lo, seg_hi, lo, hi),
                                     [((Q, L), torch.float32)])
    _build.record("lb_paa_interval", 7 * Q * L * w + Q * L,
                  4 * (2 * Q * w + 2 * L * w + Q * L), (out,))
    return out
