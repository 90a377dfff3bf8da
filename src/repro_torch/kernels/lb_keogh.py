"""CUDA kernel: squared LB_Keogh, stage 1 of the DTW candidate cascade
(``csrc/lb_keogh.cu``).

Replaces the TPU kernel ``repro/kernels/lb_keogh.py::lb_keogh`` (body
``_kernel``: one query envelope against a ``(block_b, n)`` candidate tile).
The reference's search calls the batched form ``lb_keogh2_batch_jnp``
(``[Q, m]``, for a shared candidate block or per-query candidate sets), so
the port's kernel computes that form; the one-query TPU form is Q = 1.  On
Hopper an element costs five instructions, so the shared layout is bound by
instruction issue: tiles of 32 queries × 32 candidates, each thread a 4 × 4
register tile over envelopes and rows staged in 32-column chunks, any row
length.  The per-query layout takes one query × 64 candidates a block and
is bound by bytes.  Every value is summed in one fixed order (four column
classes, each in increasing column order, added in class order), so a
(query, row) pair gives the same bits wherever it sits and in either
layout.
"""
from __future__ import annotations

import torch

from . import _build

#: launches of the CUDA kernel (a plain count; callers reset it to 0)
launches = 0


def lb_keogh(x: torch.Tensor, U: torch.Tensor, L: torch.Tensor
             ) -> torch.Tensor:
    """``x [m, n]`` or ``[Q, m, n]``, ``U/L [Q, n]`` f32 on CUDA →
    ``[Q, m]``."""
    global launches
    _build.require_cuda("lb_keogh", x=(x, (2, 3)), U=(U, 2), L=(L, 2))
    Q, n = U.shape
    m = x.shape[-2]
    if (L.shape != U.shape or x.shape[-1] != n
            or (x.dim() == 3 and x.shape[0] != Q)):
        raise ValueError(f"lb_keogh: shape mismatch x {tuple(x.shape)}, "
                         f"U {tuple(U.shape)}, L {tuple(L.shape)}")
    out = torch.empty((Q, m), dtype=torch.float32, device=x.device)
    if Q == 0 or m == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.lib().dumpy_lb_keogh_f32(
            x.data_ptr(), U.data_ptr(), L.data_ptr(), out.data_ptr(), Q, m, n,
            m if x.dim() == 3 else 0, stream)
    _build.check(err, "lb_keogh")
    launches += 1
    return out


def abstract(x: torch.Tensor, U: torch.Tensor, L: torch.Tensor
             ) -> torch.Tensor:
    """The dry run's stand-in on fake tensors: an empty ``[Q, m]`` and the
    call's work, recorded as ``lb_keogh``: the candidate rows (``m``
    shared, ``Q·m`` per query) and both envelopes read once, the bounds
    written once (bytes); seven operations an element of ``[Q, m, n]``
    (operations)."""
    Q, n = U.shape
    m = x.shape[-2]
    rows = Q * m if x.dim() == 3 else m
    (out,) = _build.abstract_outputs("lb_keogh", (x, U, L),
                                     [((Q, m), torch.float32)])
    _build.record("lb_keogh", 7 * Q * m * n,
                  4 * (rows * n + 2 * Q * n + Q * m), (out,))
    return out
