"""CUDA kernel: masked banded DTW² with cutoff early-abandon, the DP of the
exact DTW search (``csrc/dtw_band.cu``).

Replaces the TPU kernel ``repro/kernels/dtw_band.py::dtw_band`` (body
``_kernel``: a full-width ``(block_m, n)`` anti-diagonal DP per tile under a
``while_loop`` that exits when the tile's lanes are dead).  The reference's
search reaches that kernel for the shared slab and runs the same DP as
``dtw2_masked_gather_jnp`` for per-query candidate sets; this one kernel
serves both, and a third form: rows ``idx [Q, m]`` of a collection, which
spares the search a ``[Q, m, n]`` gather.  The result equals the plain
version ``core.lb._dtw2_masked_scan`` bit for bit, ``+inf`` lanes included,
for any band radius (cut to ``n - 1``: the same cells).  One warp per
(query, candidate) lane; masked lanes do no work.  Bound by the latency of
2n-1 dependent diagonal steps per lane: where ``2r + 1 <= 64`` (the
search's r = 25) each thread holds one band offset of the last two
diagonals in registers and trades one value a diagonal with a neighbour;
wider bands keep a band-compacted frontier in shared memory, or in a
scratch buffer allocated here where it does not fit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the CUDA kernel (a plain count; callers reset it to 0)
launches = 0


def dtw_band(qs: torch.Tensor, xs: torch.Tensor, mask: torch.Tensor,
             cutoff2: torch.Tensor, r: int,
             idx: torch.Tensor | None = None) -> torch.Tensor:
    """``qs [Q, n]``; candidates ``xs [m, n]``, ``xs [Q, m, n]``, or rows
    ``idx [Q, m]`` (int64) of ``xs [T, n]``; ``mask [Q, m]`` bool,
    ``cutoff2 [Q]`` f32, all on CUDA → ``[Q, m]`` squared distances."""
    global launches
    tensors = dict(qs=(qs, 2), xs=(xs, (2, 3)), cutoff2=(cutoff2, 1))
    _build.require_cuda("dtw_band", **tensors)
    Q, n = qs.shape
    m = mask.shape[1] if mask.dim() == 2 else -1
    if idx is not None:
        if (idx.device != qs.device or idx.dtype != torch.int64
                or idx.shape != (Q, m) or not idx.is_contiguous()
                or xs.dim() != 2):
            raise ValueError("dtw_band: idx must be a contiguous int64 "
                             "[Q, m] table of rows of xs [T, n] on the "
                             "same device")
    elif xs.shape[:-1] not in ((m,), (Q, m)):
        raise ValueError(f"dtw_band: xs {tuple(xs.shape)} does not match "
                         f"mask {tuple(mask.shape)}")
    if (mask.device != qs.device or mask.dtype != torch.bool
            or mask.shape != (Q, m) or not mask.is_contiguous()
            or xs.shape[-1] != n or cutoff2.shape != (Q,)):
        raise ValueError(f"dtw_band: shape mismatch qs {tuple(qs.shape)}, "
                         f"xs {tuple(xs.shape)}, mask {tuple(mask.shape)} "
                         f"{mask.dtype}, cutoff2 {tuple(cutoff2.shape)}")
    if r < 0 or n < 1:
        raise ValueError(f"dtw_band: band radius {r} < 0 or length {n} < 1")
    out = torch.empty((Q, m), dtype=torch.float32, device=qs.device)
    if Q == 0 or m == 0:
        return out
    r = min(int(r), n - 1)                 # the same cells
    lib = _build.lib()
    with torch.cuda.device(qs.device):
        floats = ctypes.c_longlong(0)   # the wide path's frontier scratch
        _build.check(lib.dumpy_dtw_band_scratch_floats(
            Q, m, n, r, ctypes.byref(floats)), "dtw_band")
        scratch = (torch.empty(floats.value, dtype=torch.float32,
                               device=qs.device) if floats.value else None)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dumpy_dtw_band_f32(
            qs.data_ptr(), xs.data_ptr(),
            None if idx is None else idx.data_ptr(), mask.data_ptr(),
            cutoff2.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), Q, m, n,
            r, m if xs.dim() == 3 else 0, stream)
    _build.check(err, "dtw_band")
    launches += 1
    return out


def abstract(qs: torch.Tensor, xs: torch.Tensor, mask: torch.Tensor,
             cutoff2: torch.Tensor, r: int,
             idx: torch.Tensor | None = None) -> torch.Tensor:
    """The dry run's stand-in on fake tensors: an empty ``[Q, m]`` and the
    call's work, recorded as ``dtw_band``.  Fake tensors hold no mask and
    no cutoff, so the work is the most the call could need: every lane on
    and none abandoned.  The queries, the candidate rows (``m`` shared,
    ``Q·m`` per query or gathered, at most the collection's rows), the
    cutoffs, mask and ``idx`` read once and the result written once
    (bytes); five operations an in-band cell (operations)."""
    Q, n = qs.shape
    m = mask.shape[1]
    rr = min(int(r), n - 1)
    cells = n * (2 * rr + 1) - rr * (rr + 1)
    if idx is not None:
        rows = min(Q * m, xs.shape[0])
    else:
        rows = Q * m if xs.dim() == 3 else m
    (out,) = _build.abstract_outputs(
        "dtw_band", (qs, xs, mask, cutoff2, idx), [((Q, m), torch.float32)])
    _build.record("dtw_band", 5 * Q * m * cells,
                  4 * (Q * n + rows * n + Q + Q * m) + Q * m
                  + (8 * Q * m if idx is not None else 0), (out,))
    return out
