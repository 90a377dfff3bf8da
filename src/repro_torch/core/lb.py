"""Lower-bounding and true distance functions (ED + DTW) — the port's copy
of ``repro.core.lb``.

The load-bearing invariant of the whole iSAX index family is::

    mindist_paa_isax(PAA(q), node) <= ED(q, s)   for every series s in node

which enables exact-search pruning (paper §5.5).  DTW follows the
iSAX-family approach (paper §7): an LB_Keogh envelope of the query is
summarized per segment and bounded against the node regions, and raw
candidates pass the LB_Keogh → LB_Improved → banded-DP cascade.  The numpy
functions are verbatim copies of the reference; the torch functions are the
plain versions of the CUDA kernels (``pairwise_l2``, ``lb_paa_interval``,
``lb_keogh``, ``lb_improved``, ``dtw_band``) and keep the reference's
operation order.
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


def sum_last_fixed(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed order: halves added elementwise
    until one column is left (an odd column joins the last add).  Each
    step is an IEEE add of two tensors, so every device gives the same
    bits, which ``.sum(-1)`` (an order of each backend's choosing) does not
    promise."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        odd = x[..., 2 * h:]
        x = x[..., :h] + x[..., h:2 * h]
        if odd.shape[-1]:
            x = torch.cat([x[..., :-1], x[..., -1:] + odd], dim=-1)
    return x[..., 0]


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


# ---------------------------------------------------------------------------
# DTW (banded) + envelope lower bounds — host copies
# ---------------------------------------------------------------------------

def dtw_envelope_np(q: np.ndarray, r: int) -> tuple[np.ndarray, np.ndarray]:
    """LB_Keogh envelope: ``U_i = max(q[i-r:i+r+1])``, ``L_i = min(...)``."""
    n = q.shape[0]
    idx = np.arange(n)
    lo_i = np.maximum(idx - r, 0)
    hi_i = np.minimum(idx + r + 1, n)
    U = np.array([q[a:z].max() for a, z in zip(lo_i, hi_i)])
    L = np.array([q[a:z].min() for a, z in zip(lo_i, hi_i)])
    return U, L


def envelope_paa_np(U: np.ndarray, L: np.ndarray, w: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Per-segment envelope summary that *preserves the bound*: the segment
    max of U and min of L (mean would break the lower-bound property)."""
    n = U.shape[0]
    return (U.reshape(w, n // w).max(axis=1), L.reshape(w, n // w).min(axis=1))


def mindist_dtw_bounds_np(U_seg: np.ndarray, L_seg: np.ndarray,
                          lo: np.ndarray, hi: np.ndarray, n: int) -> np.ndarray:
    """DTW lower bound of a query envelope vs. iSAX regions:
    ``d_j = max(0, lo_j - U_j, L_j - hi_j)`` (iSAX-DTW, MESSI)."""
    w = U_seg.shape[-1]
    below = np.maximum(lo - U_seg, 0.0)
    above = np.maximum(L_seg - hi, 0.0)
    d = np.maximum(below, above)
    return np.sqrt((n / w) * (d * d).sum(axis=-1))


def lb_keogh_np(xs: np.ndarray, U: np.ndarray, L: np.ndarray) -> np.ndarray:
    """Per-candidate LB_Keogh (DTW pre-filter): ``xs [m, n]`` → ``[m]``."""
    above = np.maximum(xs - U[None, :], 0.0)
    below = np.maximum(L[None, :] - xs, 0.0)
    d = np.maximum(above, below)
    return np.sqrt((d * d).sum(axis=1))


def dtw_np(a: np.ndarray, b_: np.ndarray, r: int) -> float:
    """Exact banded DTW (Sakoe–Chiba, window ``r``), host reference."""
    n, m = len(a), len(b_)
    INF = np.inf
    prev = np.full(m + 1, INF)
    prev[0] = 0.0
    for i in range(1, n + 1):
        cur = np.full(m + 1, INF)
        j_lo, j_hi = max(1, i - r), min(m, i + r)
        for j in range(j_lo, j_hi + 1):
            c = (a[i - 1] - b_[j - 1]) ** 2
            cur[j] = c + min(prev[j], prev[j - 1], cur[j - 1])
        prev = cur
    return float(np.sqrt(prev[m]))


def dtw_np_batch(qs: np.ndarray, cand: np.ndarray, r: int) -> np.ndarray:
    """:func:`dtw_np` vectorized over a per-query candidate set:
    ``qs [Q, n]``, ``cand [Q, kk, n]`` → ``[Q, kk]`` float64.  Each cell
    is ``fl64(fl32(d·d) + min(up, diag, left))`` — the cost squared in the
    input's dtype (f32) by an array multiply, the add in float64 — visited
    in the host's i/j order.  It agrees with the scalar :func:`dtw_np` to
    float32, not bitwise: numpy squares an f32 *scalar* through ``powf``
    and an f32 *array* by multiplying, and the two can differ in the last
    bit of a cell's cost."""
    Q, kk, n = cand.shape
    a = np.repeat(np.asarray(qs), kk, axis=0)                # [Q*kk, n]
    b_ = np.asarray(cand).reshape(Q * kk, n)
    INF = np.inf
    prev = np.full((Q * kk, n + 1), INF)
    prev[:, 0] = 0.0
    for i in range(1, n + 1):
        cur = np.full((Q * kk, n + 1), INF)
        j_lo, j_hi = max(1, i - r), min(n, i + r)
        for j in range(j_lo, j_hi + 1):
            c = (a[:, i - 1] - b_[:, j - 1]) ** 2
            cur[:, j] = c + np.minimum(
                np.minimum(prev[:, j], prev[:, j - 1]), cur[:, j - 1])
        prev = cur
    return np.sqrt(prev[:, n]).reshape(Q, kk)


# ---------------------------------------------------------------------------
# DTW envelopes and the LB cascade — plain torch (twins of the kernels)
# ---------------------------------------------------------------------------

def dtw_envelope_batch(qs: torch.Tensor, r: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """LB_Keogh envelopes for a query batch: ``qs [Q, n]`` → ``(U, L)``
    ``[Q, n]`` each (``repro.core.lb.dtw_envelope_batch_jnp``: windowed
    max/min with the edges clamped through ±inf padding; exact)."""
    return _window_max(qs, r), _window_min(qs, r)


def _window_max(x: torch.Tensor, r: int) -> torch.Tensor:
    """Sliding-window max over the last axis (window ``[i-r, i+r]``,
    edge-clamped) via van Herk/Gil–Werman: block prefix/suffix running
    maxes at block width ``2r+1``, then one max of two gathers.  Exact."""
    n = x.shape[-1]
    if r <= 0:
        return x
    w = 2 * r + 1
    nb = -(-(n + r) // w)           # blocks must cover index n-1+r
    lead_shape = x.shape[:-1]
    pad = x.new_full(lead_shape + (nb * w - n,), -torch.inf)
    blocks = torch.cat([x, pad], dim=-1).reshape(lead_shape + (nb, w))
    run = torch.cummax(blocks, dim=-1).values.reshape(lead_shape + (nb * w,))
    suf = torch.flip(torch.cummax(torch.flip(blocks, [-1]), dim=-1).values,
                     [-1]).reshape(lead_shape + (nb * w,))
    lead = x.new_full(lead_shape + (r,), -torch.inf)
    s_l = torch.cat([lead, suf], dim=-1)[..., :n]          # suf[i - r]
    r_e = run[..., r:r + n]                                # run[i + r]
    return torch.maximum(s_l, r_e)


def _window_min(x: torch.Tensor, r: int) -> torch.Tensor:
    """Sliding-window min over the last axis (same contract as
    :func:`_window_max`)."""
    return -_window_max(-x, r)


def _per_query(xs: torch.Tensor) -> torch.Tensor:
    """``[m, n]`` (shared block) → ``[1, m, n]``; ``[Q, m, n]`` (per-query
    gather layout) unchanged."""
    return xs if xs.dim() == 3 else xs[None, :, :]


def lb_keogh2_batch(xs: torch.Tensor, U: torch.Tensor, L: torch.Tensor
                    ) -> torch.Tensor:
    """Squared LB_Keogh of every candidate against every query envelope:
    ``xs [m, n]`` or ``[Q, m, n]``, ``U/L [Q, n]`` → ``[Q, m]``
    (``repro.core.lb.lb_keogh2_batch_jnp``; one ``[Q, m, n]`` temporary)."""
    xsb = _per_query(xs)
    above = torch.clamp_min(xsb - U[:, None, :], 0.0)
    below = torch.clamp_min(L[:, None, :] - xsb, 0.0)
    d = torch.maximum(above, below)
    return (d * d).sum(-1)


def lb_improved2_batch(xs: torch.Tensor, qs: torch.Tensor, U: torch.Tensor,
                       L: torch.Tensor, r: int) -> torch.Tensor:
    """Squared LB_Improved (Lemire 2009): ``LB_Keogh(x, env(q))² +
    LB_Keogh(q, env(h))²`` with ``h = clip(x, L, U)``
    (``repro.core.lb.lb_improved2_batch_jnp``, same operation order).
    ``xs [m, n]`` or ``[Q, m, n]``, ``qs/U/L [Q, n]`` → ``[Q, m]``."""
    xsb = _per_query(xs)
    above = torch.clamp_min(xsb - U[:, None, :], 0.0)
    below = torch.clamp_min(L[:, None, :] - xsb, 0.0)
    d1 = torch.maximum(above, below)
    h = torch.minimum(torch.maximum(xsb, L[:, None, :]), U[:, None, :])
    Uh = _window_max(h, r)
    Lh = _window_min(h, r)
    d2 = torch.maximum(torch.clamp_min(qs[:, None, :] - Uh, 0.0),
                       torch.clamp_min(Lh - qs[:, None, :], 0.0))
    return (d1 * d1).sum(-1) + (d2 * d2).sum(-1)


# ---------------------------------------------------------------------------
# masked banded DTW² — the anti-diagonal DP (twin of the dtw_band kernel)
# ---------------------------------------------------------------------------

def _dtw_base(d: int, r: int, n: int) -> int:
    """First column of the band-compacted frontier of anti-diagonal ``d``:
    ``clip(ceil((d - r) / 2), 0, n - 1 - r)``."""
    return min(max((d - r + 1) // 2, 0), n - 1 - r)


def dtw_final_slot(n: int, r: int) -> int:
    """Frontier slot of the cell ``(n-1, n-1)`` on the last anti-diagonal
    (``n - 1`` in the full-width fallback ``r + 1 >= n``)."""
    if r + 1 >= n:
        return n - 1
    return (n - 1) - _dtw_base(2 * n - 2, r, n)


def _dtw2_masked_scan(qs: torch.Tensor, xs: torch.Tensor, r: int,
                      mask: torch.Tensor, cutoff2: torch.Tensor,
                      return_steps: bool = False):
    """Anti-diagonal banded DTW² with lane masking and cutoff early-abandon
    (``repro.core.lb._dtw2_masked_scan`` and its full-width fallback
    ``_dtw2_masked_scan_full``, vmapped over queries): ``qs [Q, n]``,
    ``xs [Q, m, n]`` (a broadcast view for a shared block), ``mask [Q, m]``,
    ``cutoff2 [Q]`` → ``[Q, m]`` (``+inf`` on masked/abandoned lanes).

    Slot ``o`` of diagonal ``d`` is column ``j = base(d) + o`` (``base ≡ 0``
    and ``n`` slots when ``r + 1 >= n``).  A lane dies when the min over its
    last two diagonals exceeds ``cutoff2``; the loop exits when every lane
    is dead.

    A cell is ``fl32(fl64(d·d + best))`` with ``d`` the f32 difference: the
    reference's compiled DP contracts ``d·d + best`` into one fused
    multiply-add, and the f64 form rounds the same way (the square is exact
    in f64; the two roundings differ only when the f64 sum lands exactly on
    an f32 rounding tie).  The ``dtw_band`` kernel does the same f64
    arithmetic, so kernel and twin agree bit for bit.

    ``return_steps=True`` also returns ``int64 [Q, m]``: the diagonals each
    lane computed before it died (0 on masked lanes, ``2n - 1`` on lanes
    that finish), the work this run's data needs."""
    Q, m, n = xs.shape
    full = r + 1 >= n
    Wb = n if full else r + 1
    inf = torch.inf
    dev = xs.device
    oidx = torch.arange(Wb, device=dev)
    pad1 = torch.full((Q, m, 1), inf, dtype=torch.float32, device=dev)
    dm2 = torch.full((Q, m, Wb), inf, dtype=torch.float32, device=dev)
    dm1 = dm2.clone()
    alive = mask.clone()
    ct = cutoff2[:, None]
    steps = torch.zeros((Q, m), dtype=torch.int64, device=dev)

    def base(d):
        return 0 if full else _dtw_base(d, r, n)

    for d in range(2 * n - 1):
        if not bool(alive.any()):  # lint: allow-sync: the twin's early exit
            break
        if return_steps:
            steps += alive
        b = base(d)
        s1 = b - base(d - 1)
        s2 = b - base(d - 2)
        j = b + oidx                                        # [Wb] columns
        i = d - j                                           # [Wb] rows
        valid = (i >= 0) & (i < n) & (j < n) & ((i - j).abs() <= r)
        jc = j.clamp(max=n - 1)
        ic = i.clamp(0, n - 1)
        # cost(i, j) + best rounds once, as the reference's fused
        # multiply-add does: the f32 square is exact in f64
        diff = (xs[:, :, jc] - qs[:, None, ic]).double()
        up = torch.cat([dm1, pad1], 2)[:, :, s1:s1 + Wb]           # dm1[o+s1]
        left = torch.cat([pad1, dm1, pad1], 2)[:, :, s1:s1 + Wb]   # dm1[o+s1-1]
        diag = torch.cat([pad1, dm2, pad1, pad1], 2)[:, :, s2:s2 + Wb]
        best = torch.minimum(torch.minimum(up, left), diag)
        if d == 0:
            best = torch.where(j == 0, 0.0, best)
        out = torch.where(valid, (diff * diff + best).float(), inf)
        lane_min = torch.minimum(out.amin(dim=2), dm1.amin(dim=2))
        alive = alive & (lane_min <= ct)
        dm2, dm1 = dm1, out
    out = torch.where(alive, dm1[:, :, dtw_final_slot(n, r)], inf)
    return (out, steps) if return_steps else out


def dtw2_masked_batch(qs: torch.Tensor, xs: torch.Tensor, r: int,
                      mask: torch.Tensor, cutoff2: torch.Tensor
                      ) -> torch.Tensor:
    """Masked banded DTW² of a query batch vs a shared candidate block:
    ``qs [Q, n]``, ``xs [m, n]``, ``mask [Q, m]``, ``cutoff2 [Q]`` →
    ``[Q, m]`` (``repro.core.lb.dtw2_masked_batch_jnp``)."""
    Q = qs.shape[0]
    return _dtw2_masked_scan(qs, xs[None].expand(Q, -1, -1), r, mask,
                             cutoff2)


def dtw2_masked_gather(qs: torch.Tensor, cand: torch.Tensor, r: int,
                       mask: torch.Tensor, cutoff2: torch.Tensor,
                       return_steps: bool = False):
    """Masked banded DTW² with per-query candidate sets ``cand [Q, m, n]``
    (``repro.core.lb.dtw2_masked_gather_jnp``); ``return_steps`` as in
    :func:`_dtw2_masked_scan`."""
    return _dtw2_masked_scan(qs, cand, r, mask, cutoff2, return_steps)
