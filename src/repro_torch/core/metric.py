"""Pluggable search metric (paper §7) — the port's copy of
``repro.core.metric``.

Every search path needs three metric-specific ingredients: a query
preprocessing into a per-segment interval ``[seg_lo, seg_hi]`` (plus a
full-resolution envelope), the interval MINDIST region bound

    d_j = max(0, lo_j - seg_hi_j, seg_lo_j - hi_j)
    LB   = (n/w) * sum_j d_j^2                       (squared form)

and a candidate distance.  For ED the interval degenerates to the query's
PAA and the envelope to the query itself; for DTW they are the LB_Keogh
envelope over the Sakoe–Chiba band and its bound-preserving per-segment
summary (max of U, min of L), and the candidate distance is the
LB_Keogh → LB_Improved → banded-DP cascade.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .lb import dtw_envelope_batch, dtw_envelope_np, envelope_paa_np


def default_band(n: int) -> int:
    """The Sakoe–Chiba half-width used throughout the repo (paper §7:
    10% of the series length)."""
    return max(1, int(0.1 * n))


#: Candidate-ordering strategies for the exact device search (DTW only —
#: the ED program ignores the knob).
ORDERS = ("shared", "perq", "cluster")


@dataclasses.dataclass(frozen=True)
class Metric:
    """A search metric: ``name`` ∈ {"ed", "dtw"}, the DTW band (ignored for
    ED), and the exact-search candidate-ordering strategy ``order`` (one of
    :data:`ORDERS`; only the DTW device program reads it)."""
    name: str = "ed"
    band: int = 0
    order: str = "shared"

    def __post_init__(self):
        if self.name not in ("ed", "dtw"):
            raise ValueError(f"unknown metric {self.name!r}")
        if self.order not in ORDERS:
            raise ValueError(f"unknown order {self.order!r} (one of {ORDERS})")

    @property
    def is_dtw(self) -> bool:
        return self.name == "dtw"


ED = Metric("ed", 0)

#: Default ordering for DTW exact device search (the reference's default).
DTW_DEFAULT_ORDER = "cluster"


def resolve(metric, n: int, band: int | None = None,
            order: str | None = None) -> Metric:
    """Normalize a user-facing ``metric`` (string or Metric) + optional
    ``band`` / ``order`` overrides into a concrete :class:`Metric` for
    series length ``n`` (DTW band defaults to ``0.1 n``; DTW order defaults
    to :data:`DTW_DEFAULT_ORDER`)."""
    if isinstance(metric, Metric):
        if order is not None and order != metric.order:
            return dataclasses.replace(metric, order=order)
        return metric
    if metric == "ed":
        return ED if order is None else dataclasses.replace(ED, order=order)
    return Metric("dtw",
                  int(band) if band is not None else default_band(n),
                  order if order is not None else DTW_DEFAULT_ORDER)


# ---------------------------------------------------------------------------
# query preprocessing
# ---------------------------------------------------------------------------

def query_prep_np(metric: Metric, q: np.ndarray, paa_q: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host prep of one query → ``(seg_lo, seg_hi, env_lo, env_hi)``."""
    if not metric.is_dtw:
        return paa_q, paa_q, q, q
    U, L = dtw_envelope_np(q, metric.band)
    U_seg, L_seg = envelope_paa_np(U, L, paa_q.shape[-1])
    return L_seg, U_seg, L, U


def query_prep(metric: Metric, qs: torch.Tensor, paa_q: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Device prep of a query batch ``qs [Q, n]`` →
    ``(seg_lo [Q,w], seg_hi [Q,w], env_lo [Q,n], env_hi [Q,n])``
    (``repro.core.metric.query_prep_jnp``).  For ED the interval is the PAA
    itself and the envelope slots carry ``qs``; for DTW the batched
    LB_Keogh envelope and its segment max/min summary."""
    if not metric.is_dtw:
        return paa_q, paa_q, qs, qs
    Q, n = qs.shape
    w = paa_q.shape[-1]
    U, L = dtw_envelope_batch(qs, metric.band)
    U_seg = U.reshape(Q, w, n // w).amax(dim=-1)
    L_seg = L.reshape(Q, w, n // w).amin(dim=-1)
    return L_seg, U_seg, L, U


# ---------------------------------------------------------------------------
# interval MINDIST — the one region lower bound both metrics share
# ---------------------------------------------------------------------------

def interval_mindist_np(seg_lo: np.ndarray, seg_hi: np.ndarray,
                        lo: np.ndarray, hi: np.ndarray, n: int) -> np.ndarray:
    """Host interval MINDIST (sqrt form, the host heap's scale):
    ``seg_lo/seg_hi [..., w]`` query interval vs ``lo/hi [..., w]`` regions.
    With ``seg_lo == seg_hi == PAA(q)`` this is bitwise
    ``mindist_paa_bounds_np``."""
    w = seg_lo.shape[-1]
    below = np.maximum(lo - seg_hi, 0.0)
    above = np.maximum(seg_lo - hi, 0.0)
    d = np.maximum(below, above)
    return np.sqrt((n / w) * (d * d).sum(axis=-1))
