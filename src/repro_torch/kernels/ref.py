"""Plain PyTorch versions of the CUDA kernels (twins of
``repro/kernels/ref.py``).

Each function is the specification its kernel must match: the CPU tests hold
them against the reference's oracles, and ``chip_smoke.py`` holds every
kernel against its twin on the card.  ``kernels.ops`` routes a CPU tensor
here; nothing on the main path calls them when the tensors are on CUDA.
"""
from __future__ import annotations

import torch

from ..core.lb import (dtw2_masked_batch, dtw2_masked_gather, ed2_batch,
                       lb_improved2_batch, lb_interval, lb_keogh2_batch)
from ..core.sax import breakpoints_t, sax_encode_t


def sax_encode_ref(x: torch.Tensor, w: int, b: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """PAA (segment mean) + SAX symbols (searchsorted right):
    ``x [B, n] -> (paa [B, w] f32, sax [B, w] i32)``."""
    paa, sax = sax_encode_t(x, w, b)
    return paa, sax.to(torch.int32)


def sax_encode_in_order(x: torch.Tensor, w: int, b: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's exact operation order, for bitwise checks on the
    card: each segment summed in order from +0 (one rounding an add), then
    divided by its length; the symbol ``searchsorted(bp, paa, right=True)``
    over the float32 breakpoints.  ``x [B, n] -> (paa [B, w] f32, sax
    [B, w] i64)``."""
    B, n = x.shape
    seg = n // w
    v = x.view(B, w, seg)
    s = torch.zeros((B, w), dtype=torch.float32, device=x.device)
    for i in range(seg):
        s = s + v[:, :, i]
    # a tensor divisor: on CUDA PyTorch applies a CPU scalar divisor as a
    # product with its reciprocal
    paa = s / torch.tensor(float(seg), device=x.device)
    bp = breakpoints_t(b, torch.float32, x.device)
    return paa, torch.searchsorted(bp, paa, right=True)


def pairwise_l2_ref(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared L2: ``q [Q, n]``, ``x [X, n]`` → ``[Q, X] f32``."""
    return ed2_batch(q.to(torch.float32), x.to(torch.float32))


def lb_paa_interval_ref(seg_lo: torch.Tensor, seg_hi: torch.Tensor,
                        lo: torch.Tensor, hi: torch.Tensor, n: int
                        ) -> torch.Tensor:
    """Squared interval MINDIST: ``seg_lo/seg_hi [Q, w]``, ``lo/hi [L, w]``
    → ``[Q, L] f32`` (scaled by n/w)."""
    return lb_interval(seg_lo, seg_hi, lo, hi, n)


def lb_paa_interval_in_order(seg_lo: torch.Tensor, seg_hi: torch.Tensor,
                             lo: torch.Tensor, hi: torch.Tensor, n: int
                             ) -> torch.Tensor:
    """The CUDA kernel's exact operation order, for bitwise checks on the
    card: over j in order ``acc = acc + d*d`` (separate operations, so no
    contraction into an FMA), then ``(n / w) * acc``."""
    w = seg_lo.shape[1]
    acc = torch.zeros((seg_lo.shape[0], lo.shape[0]), device=lo.device)
    for j in range(w):
        below = torch.clamp_min(lo[None, :, j] - seg_hi[:, j, None], 0.0)
        above = torch.clamp_min(seg_lo[:, j, None] - hi[None, :, j], 0.0)
        d = torch.maximum(below, above)
        acc = acc + d * d
    return (n / w) * acc


def lb_isax_ref(paa_q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                n: int) -> torch.Tensor:
    """Squared MINDIST(PAA, region): the degenerate interval."""
    return lb_interval(paa_q, paa_q, lo, hi, n)


def lb_keogh_ref(x: torch.Tensor, U: torch.Tensor, L: torch.Tensor
                 ) -> torch.Tensor:
    """Squared LB_Keogh: ``x [m, n]`` or ``[Q, m, n]``, ``U/L [Q, n]`` →
    ``[Q, m] f32`` (the TPU kernel's one-envelope form is Q = 1)."""
    return lb_keogh2_batch(x, U, L)


def lb_improved_ref(x: torch.Tensor, qs: torch.Tensor, U: torch.Tensor,
                    L: torch.Tensor, r: int) -> torch.Tensor:
    """Squared LB_Improved: ``x [m, n]`` or ``[Q, m, n]``, ``qs/U/L [Q, n]``
    → ``[Q, m] f32``."""
    return lb_improved2_batch(x, qs, U, L, r)


def dtw_band_ref(qs: torch.Tensor, xs: torch.Tensor, mask: torch.Tensor,
                 cutoff2: torch.Tensor, r: int,
                 idx: torch.Tensor | None = None) -> torch.Tensor:
    """Masked banded DTW²: candidates ``xs [m, n]`` (shared), ``[Q, m, n]``
    (per query) or rows ``idx [Q, m]`` of ``xs [T, n]`` → ``[Q, m] f32``,
    ``+inf`` on masked and abandoned lanes."""
    if idx is not None:
        return dtw2_masked_gather(qs, xs[idx], r, mask, cutoff2)
    if xs.dim() == 3:
        return dtw2_masked_gather(qs, xs, r, mask, cutoff2)
    return dtw2_masked_batch(qs, xs, r, mask, cutoff2)
