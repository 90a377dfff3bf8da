"""CUDA kernel: fused PAA + SAX symbolization (``csrc/sax_encode.cu``).

Replaces the TPU kernel ``repro/kernels/sax_encode.py::sax_encode`` (body
``_kernel``), which computes PAA as a matmul with the segment-averaging
matrix on the MXU and counts breakpoints with 128-lane broadcast compares.
On Hopper it is one pass over ``x [B, n]`` (``B·n·4`` bytes) for ``B·n``
adds: below one launch at the query batch (``[64, 256]``), bound by device
memory over a collection.  The rows are a run of ``B·w`` segments; a block
stages 256 of them at a time in shared memory with asynchronous copies
(16-byte where the segment length is a multiple of 4 and ``x`` is aligned,
else 4-byte), three tiles ahead, and one wave of blocks walks the tiles.
Each thread sums one segment in order, divides by its length (the segment
mean that ``sax_encode_t`` computes, bitwise equal to an in-order sum), and
counts the breakpoints not above it as ``torch.searchsorted(...,
right=True)`` does.
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


def abstract(x: torch.Tensor, w: int, b: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dry run's stand-in on fake tensors: empty ``(paa f32 [B, w],
    sax i32 [B, w])`` and the call's work, recorded as ``sax_encode``: the
    rows read once, both tables written once and the ``2**b - 1``
    breakpoints read (bytes); a sum a sample, a mean and ``b`` comparisons
    a segment (operations)."""
    B, n = x.shape
    paa, sax = _build.abstract_outputs(
        "sax_encode", (x,), [((B, w), torch.float32), ((B, w), torch.int32)])
    _build.record("sax_encode", B * n + B * w + B * w * b,
                  4 * (B * n + 2 * B * w + (2 ** b - 1)), (paa, sax))
    return paa, sax
