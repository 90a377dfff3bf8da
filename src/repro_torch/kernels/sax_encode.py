"""CUDA kernel: fused PAA + SAX symbolization (``csrc/sax_encode.cu``).

Replaces the TPU kernel ``repro/kernels/sax_encode.py::sax_encode`` (body
``_kernel``), which computes PAA as a matmul with the segment-averaging
matrix on the MXU and counts breakpoints with 128-lane broadcast compares.
On Hopper the work is tiny and memory-bound: one pass over ``x [B, n]``
(``B·n·4`` bytes) against ``B·n`` adds and ``B·w·log2(c)`` compares.  The
kernel gives each thread one (row, segment): it sums the segment in order,
divides by its length (the segment mean that ``sax_encode_t`` computes),
and binary-searches the ``c - 1`` breakpoints staged in shared memory.  At
the query-encoding shape (``[64, 256]``) it is bound by launch latency.
"""
from __future__ import annotations

import torch

from ..core.sax import breakpoints_t
from . import _build

#: launches of the CUDA kernel (a plain count; callers reset it to 0)
launches = 0


def sax_encode(x: torch.Tensor, w: int, b: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [B, n] f32`` on CUDA → ``(paa [B, w] f32, sax [B, w] i32)``."""
    global launches
    _build.require_cuda("sax_encode", x=(x, 2))
    B, n = x.shape
    if n % w:
        raise ValueError(f"n={n} must be divisible by w={w}")
    if not 1 <= b <= 12:
        raise ValueError(f"b={b}: the breakpoint table must fit shared memory "
                         f"(1 <= b <= 12)")
    paa = torch.empty((B, w), dtype=torch.float32, device=x.device)
    sax = torch.empty((B, w), dtype=torch.int32, device=x.device)
    if B == 0:
        return paa, sax
    bp = breakpoints_t(b, torch.float32, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.lib().dumpy_sax_encode_f32(
            x.data_ptr(), bp.data_ptr(), paa.data_ptr(), sax.data_ptr(),
            B, n, w, bp.numel(), stream)
    _build.check(err, "sax_encode")
    launches += 1
    return paa, sax
