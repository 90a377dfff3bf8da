"""Dumpy-Fuzzy boundary duplication (paper §6).

At each split, series whose PAA value on a chosen segment lies within
``f * (parent region width)`` of the new breakpoint are *duplicated* into the
1-bit-sibling child.  Each series is replicated at most ``max_replica`` times
in total (paper §7: 3).  Duplicates never alter node iSAX words, so exact-
search pruning is untouched; they only enrich approximate-search candidates.
"""
from __future__ import annotations

import numpy as np

from .sax import breakpoints_ext, region_midpoints


def _finite_bounds(sym: np.ndarray, card: np.ndarray, b: int) -> tuple[np.ndarray, np.ndarray]:
    """Parent region bounds per segment with the unbounded edge regions
    clamped to the edge-region representative values (finite widths)."""
    bpe = breakpoints_ext(b)
    mids = region_midpoints(b)
    shift = b - card
    lo = bpe[sym << shift]
    hi = bpe[(sym + 1) << shift]
    lo = np.where(np.isinf(lo), mids[0], lo)
    hi = np.where(np.isinf(hi), mids[-1], hi)
    return lo, hi


def fuzzy_duplicates(paa_node: np.ndarray,
                     sids: np.ndarray,
                     parent_sym: np.ndarray,
                     parent_card: np.ndarray,
                     csl: tuple[int, ...],
                     b: int,
                     f: float,
                     existing_sids: set[int],
                     rep_budget: np.ndarray,
                     ids: np.ndarray) -> list[tuple[int, np.ndarray]]:
    """Compute duplicate assignments for one split.

    ``paa_node [c, w]`` — PAA of the node's series; ``sids [c]`` — the split
    assignment; ``rep_budget`` — the *global* remaining-replica array indexed
    by original id (decremented in place); ``ids [c]`` — original ids of the
    node's series.  Returns ``[(dup_sid, local_indices), ...]`` restricted to
    children that actually exist (non-empty).
    """
    if f <= 0.0:
        return []
    lam = len(csl)
    bpe = breakpoints_ext(b)
    sym = parent_sym.astype(np.int64)
    card = parent_card.astype(np.int64)
    lo_all, hi_all = _finite_bounds(sym, card, b)

    out: list[tuple[int, np.ndarray]] = []
    for pos, seg in enumerate(csl):
        bitpos = lam - 1 - pos
        # Breakpoint introduced by this segment's refinement: boundary between
        # child prefixes (sym<<1|0) and (sym<<1|1) at cardinality card+1.
        m_idx = ((sym[seg] << 1) | 1) << (b - card[seg] - 1)
        m = bpe[m_idx]
        width = hi_all[seg] - lo_all[seg]
        band = f * width
        vals = paa_node[:, seg]
        near = np.abs(vals - m) <= band
        cand = near & (rep_budget[ids] > 0)
        if not cand.any():
            continue
        dup_sids = sids[cand] ^ (1 << bitpos)
        idx = np.nonzero(cand)[0]
        # group by target sid; only duplicate into non-empty children
        for tgt in np.unique(dup_sids):
            if int(tgt) not in existing_sids:
                continue
            sel = idx[dup_sids == tgt]
            sel = sel[rep_budget[ids[sel]] > 0]
            if sel.size == 0:
                continue
            rep_budget[ids[sel]] -= 1
            out.append((int(tgt), sel))
    return out
