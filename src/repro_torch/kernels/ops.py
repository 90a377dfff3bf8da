"""Dispatch for the kernels (mirror of ``repro/kernels/ops.py``).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to its plain
PyTorch twin in ``kernels.ref``.  There is no fallback: a kernel that fails
to build or launch raises.  Callers never choose between the two.
"""
from __future__ import annotations

import torch

from . import dtw_band as _dtw
from . import lb_improved as _lbi
from . import lb_isax as _lb
from . import lb_keogh as _lbk
from . import pairwise_l2 as _pl2
from . import ref
from . import sax_encode as _se


def sax_encode(x: torch.Tensor, w: int, b: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused PAA+SAX.  ``[B, n] → (f32 [B,w], i32 [B,w])``."""
    if x.is_cuda:
        return _se.sax_encode(x, w, b)
    return ref.sax_encode_ref(x, w, b)


def pairwise_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared distance matrix ``[Q, X]`` (the ED candidate slab)."""
    if q.is_cuda:
        return _pl2.pairwise_l2(q, x)
    return ref.pairwise_l2_ref(q, x)


def lb_paa_interval(seg_lo: torch.Tensor, seg_hi: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """Squared interval MINDIST ``[Q, L]`` — the pruning scan.  The CPU
    twin is the kernel's own in-order sum, so the CPU and the card rank
    near-tied leaves alike, bit for bit."""
    if seg_lo.is_cuda:
        return _lb.lb_paa_interval(seg_lo, seg_hi, lo, hi, n)
    return ref.lb_paa_interval_in_order(seg_lo, seg_hi, lo, hi, n)


def lb_isax(paa_q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
            n: int) -> torch.Tensor:
    """Squared MINDIST to every leaf pack ``[Q, L]`` (degenerate interval)."""
    return lb_paa_interval(paa_q, paa_q, lo, hi, n)


def lb_keogh(x: torch.Tensor, U: torch.Tensor, L: torch.Tensor
             ) -> torch.Tensor:
    """Squared LB_Keogh ``[Q, m]`` (DTW cascade stage 1): candidates
    ``x [m, n]`` shared by the batch or ``[Q, m, n]`` per query."""
    if x.is_cuda:
        return _lbk.lb_keogh(x, U, L)
    return ref.lb_keogh_ref(x, U, L)


def lb_improved(x: torch.Tensor, qs: torch.Tensor, U: torch.Tensor,
                L: torch.Tensor, r: int) -> torch.Tensor:
    """Squared LB_Improved ``[Q, m]`` (DTW cascade stage 2; dominates
    ``lb_keogh`` and still lower-bounds DTW²), same layouts."""
    if x.is_cuda:
        return _lbi.lb_improved(x, qs, U, L, r)
    return ref.lb_improved_ref(x, qs, U, L, r)


def dtw_band(qs: torch.Tensor, xs: torch.Tensor, mask: torch.Tensor,
             cutoff2: torch.Tensor, r: int,
             idx: torch.Tensor | None = None) -> torch.Tensor:
    """Masked banded DTW² ``[Q, m]`` with cutoff early-abandon (the final
    cascade stage): candidates ``xs [m, n]``, ``[Q, m, n]``, or rows
    ``idx [Q, m]`` of ``xs [T, n]``."""
    if qs.is_cuda:
        return _dtw.dtw_band(qs, xs, mask, cutoff2, r, idx)
    return ref.dtw_band_ref(qs, xs, mask, cutoff2, r, idx)


def knn_from_leaves(q: torch.Tensor, db_ordered: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a contiguous candidate slab: distances by ``pairwise_l2``,
    selection by a stable ascending sort, so equal distances keep the lower
    position first (``lax.top_k``'s order).  Returns (ordered-position ids,
    d2)."""
    d2 = pairwise_l2(q[None, :], db_ordered)[0]
    d2s, idx = torch.sort(d2, stable=True)
    k = min(k, d2.shape[0])
    return idx[:k], d2s[:k]


def topk_merge(topd: torch.Tensor, topi: torch.Tensor, d2: torch.Tensor,
               ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query top-k merge step of the batched search loop
    (``repro.kernels.ops.topk_merge``; not a kernel there either).

    ``topd/topi [Q, k]`` running best (squared dist, id), ascending;
    ``d2 [Q, C]`` new candidate distances with ``ids [Q, C]``.  Masked-out
    candidates must arrive as ``+inf``.  ``torch.topk`` does not promise
    ``lax.top_k``'s order among equal distances; the search's dedup and
    host re-rank depend only on the merged value set, so results do not
    depend on it."""
    k = topd.shape[1]
    alld = torch.cat([topd, d2], dim=1)
    alli = torch.cat([topi, ids], dim=1)
    vals, sel = torch.topk(alld, k, dim=1, largest=False, sorted=True)
    return vals, torch.gather(alli, 1, sel)
