"""Lower-bounding and true distance functions, Euclidean half — the port's
copy of ``repro.core.lb``.

The load-bearing invariant of the whole iSAX index family is::

    mindist_paa_isax(PAA(q), node) <= ED(q, s)   for every series s in node

which enables exact-search pruning (paper §5.5).  The numpy functions are
verbatim copies of the reference; the torch functions are the plain versions
of the ``pairwise_l2`` and ``lb_paa_interval`` CUDA kernels and keep the
reference's operation order.  The DTW half arrives with the DTW slice.
"""
from __future__ import annotations

import numpy as np
import torch

from .sax import isax_bounds_np


# ---------------------------------------------------------------------------
# Euclidean distance (true)
# ---------------------------------------------------------------------------

def ed_np(q: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Squared-free ED: ``q [n]``, ``xs [m, n]`` → ``[m]``."""
    d = xs - q[None, :]
    return np.sqrt((d * d).sum(axis=1))


def ed2_batch(q: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Squared ED, batched: ``q [Q, n]``, ``xs [m, n]`` → ``[Q, m]``, in the
    ``|q|^2 + |x|^2 - 2 q·x`` form of ``repro.core.lb.ed2_batch_jnp`` (the
    same math as the ``pairwise_l2`` kernel; this is its plain version)."""
    qn = (q * q).sum(dim=-1, keepdim=True)            # [Q, 1]
    xn = (xs * xs).sum(dim=-1)[None, :]               # [1, m]
    cross = q @ xs.T                                  # [Q, m]
    return torch.clamp_min(qn + xn - 2.0 * cross, 0.0)


# ---------------------------------------------------------------------------
# MINDIST(PAA(q), iSAX region)  — ED lower bound
# ---------------------------------------------------------------------------

def mindist_paa_bounds_np(paa_q: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                          n: int) -> np.ndarray:
    """ED lower bound between a query and everything inside a region.

    ``paa_q: [w]``; ``lo/hi: [..., w]`` region bounds → ``[...]`` distances.
    ``sqrt(n/w * sum_j d_j^2)`` with ``d_j = max(0, lo_j - paa_j, paa_j - hi_j)``.
    """
    w = paa_q.shape[-1]
    below = np.maximum(lo - paa_q, 0.0)
    above = np.maximum(paa_q - hi, 0.0)
    d = np.maximum(below, above)
    return np.sqrt((n / w) * (d * d).sum(axis=-1))


def node_bounds_np(sym: np.ndarray, card: np.ndarray, b: int,
                   clamp: float = 1e9) -> tuple[np.ndarray, np.ndarray]:
    """Finite (clamped) region bounds for node tables, ready for device use."""
    lo, hi = isax_bounds_np(sym, card, b)
    return (np.clip(lo, -clamp, clamp).astype(np.float32),
            np.clip(hi, -clamp, clamp).astype(np.float32))


def lb_interval(seg_lo: torch.Tensor, seg_hi: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor, n: int) -> torch.Tensor:
    """Interval MINDIST, batched + squared: query intervals
    ``seg_lo/seg_hi [Q, w]`` vs regions ``lo/hi [L, w]`` → ``[Q, L]``
    (``repro.core.lb.lb_interval_jnp``, same operation order).  A degenerate
    interval (``seg_lo == seg_hi == PAA(q)``) gives the ED MINDIST.  Regions
    bounded by ``+inf`` (the pad leaf) come out ``+inf``, never NaN."""
    w = seg_lo.shape[-1]
    below = torch.clamp_min(lo[None, :, :] - seg_hi[:, None, :], 0.0)
    above = torch.clamp_min(seg_lo[:, None, :] - hi[None, :, :], 0.0)
    d = torch.maximum(below, above)
    return (n / w) * (d * d).sum(dim=-1)
