"""CUDA kernel: squared LB_Improved, stage 2 of the DTW candidate cascade
(``csrc/lb_improved.cu``).

Replaces the TPU kernel ``repro/kernels/lb_keogh.py::lb_improved`` (body
``_improved_kernel``: LB_Keogh² plus LB_Keogh² of the query against the
envelope of the candidate's projection ``h = clip(x, L, U)``, with a van
Herk sliding max/min over a ``(block_b, n)`` tile).  As for ``lb_keogh`` the
port computes the batched ``[Q, m]`` form the search calls
(``lb_improved2_batch_jnp``).  ``h`` depends on the query and the candidate,
so the sliding window runs per pair.  The first design (one warp per pair,
log2(2r+1) doubling passes over a padded row in shared memory) was bound by
~42 shared-memory accesses and two warp syncs per element.  This one gives
each pair a thread (a warp: one query, 32 candidates) that streams its row
once with van Herk / Gil–Werman blocks of width 2r+1: a running prefix in
registers and one in-place backward suffix pass per block into a buffer of
``min(2r+1, n)`` slots a side, 16 operations and 6 buffer accesses per
element, no sync in the inner loop (exact: max and min do not round).  The
buffers cap an SM at 16 resident warps at r=25; within that, issue slots
and the shared-memory pipe bound it.
"""
from __future__ import annotations

import torch

from . import _build

#: launches of the CUDA kernel (a plain count; callers reset it to 0)
launches = 0


def lb_improved(x: torch.Tensor, qs: torch.Tensor, U: torch.Tensor,
                L: torch.Tensor, r: int) -> torch.Tensor:
    """``x [m, n]`` or ``[Q, m, n]``, ``qs/U/L [Q, n]`` f32 on CUDA, band
    radius ``r`` → ``[Q, m]``."""
    global launches
    _build.require_cuda("lb_improved", x=(x, (2, 3)), qs=(qs, 2), U=(U, 2),
                        L=(L, 2))
    Q, n = qs.shape
    m = x.shape[-2]
    if (U.shape != qs.shape or L.shape != qs.shape or x.shape[-1] != n
            or (x.dim() == 3 and x.shape[0] != Q)):
        raise ValueError(f"lb_improved: shape mismatch x {tuple(x.shape)}, "
                         f"qs {tuple(qs.shape)}")
    if r < 0:
        raise ValueError(f"lb_improved: band radius {r} < 0")
    out = torch.empty((Q, m), dtype=torch.float32, device=x.device)
    if Q == 0 or m == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.lib().dumpy_lb_improved_f32(
            x.data_ptr(), qs.data_ptr(), U.data_ptr(), L.data_ptr(),
            out.data_ptr(), Q, m, n, int(r), m if x.dim() == 3 else 0, stream)
    _build.check(err, "lb_improved")
    launches += 1
    return out


def abstract(x: torch.Tensor, qs: torch.Tensor, U: torch.Tensor,
             L: torch.Tensor, r: int) -> torch.Tensor:
    """The dry run's stand-in on fake tensors: an empty ``[Q, m]`` and the
    call's work, recorded as ``lb_improved``: the candidate rows, the
    queries and both envelopes read once, the bounds written once (bytes);
    twenty operations an element of ``[Q, m, n]`` (operations)."""
    Q, n = qs.shape
    m = x.shape[-2]
    rows = Q * m if x.dim() == 3 else m
    (out,) = _build.abstract_outputs("lb_improved", (x, qs, U, L),
                                     [((Q, m), torch.float32)])
    _build.record("lb_improved", 20 * Q * m * n,
                  4 * (rows * n + 3 * Q * n + Q * m), (out,))
    return out
