"""Adaptive node splitting (paper §5.3, Algorithm 2).

Given a full node, choose the subset ``csl`` of SAX segments to split on that
maximizes the proximity/compactness objective (Eq. 1):

    max_csl   exp(sqrt(Var(X'_N) / |csl|))  +  alpha * exp(-(1 + o) * sigma_F)

with the paper's three speedups:

1. **Pre-computed per-segment variance** (Eq. 2): ``Var(X'_N)`` is additive
   over the chosen segments, so each candidate plan's proximity term is a
   constant-time table lookup.
2. **Fill-factor band** (Eq. 3): the admissible number of chosen segments
   ``lambda = |csl|`` is bounded so average child fill factor lies in
   ``[F_l, F_r]`` (defaults 50% / 300%).
3. **Hierarchical child sizes**: one ``2**m`` histogram of "next-bit" codes
   over the candidate segments is computed once; every plan's child-size
   vector is a *marginalization* of it (sum over the dropped bit axes), and
   sub-plans reuse their parent plan's histogram (Alg. 2 ``calcDist`` DFS).

The histogram itself is produced on device (sharded ``bincount`` + psum in the
distributed builder — see ``core/distributed.py``); everything here is
host-side control logic operating on that 2**m vector.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np

from .sax import region_midpoints


@dataclasses.dataclass(frozen=True)
class SplitParams:
    """Split-strategy knobs (paper §5.3/§7 defaults)."""

    th: int = 10_000        # leaf capacity
    alpha: float = 0.2      # Eq. 1 weight (paper Fig. 16b sweet spot)
    f_low: float = 0.5      # F_l  — Eq. 3 fill-factor band
    f_high: float = 3.0     # F_r
    max_eval_plans: int = 200_000   # safety valve for pathological w


def lambda_range(c_n: int, th: int, f_low: float, f_high: float,
                 max_lambda: int) -> tuple[int, int]:
    """Eq. 3: admissible ``|csl|`` band for a node of size ``c_n``.

    ``max(1, log2(c_n/(F_r*th))) <= |csl| <= min(w, log2(c_n/(F_l*th)))``.
    Rounded to ints conservatively; degenerate bands collapse to a single
    valid value.
    """
    lo = max(1, math.ceil(math.log2(max(c_n / (f_high * th), 1.0))))
    hi = min(max_lambda, math.floor(math.log2(max(c_n / (f_low * th), 2.0))))
    lo = min(lo, max_lambda)
    if hi < lo:
        hi = lo
    return lo, hi


def segment_variances(sax_node: np.ndarray, b: int) -> np.ndarray:
    """Per-segment variance of region-midpoint values (Eq. 2 precompute).

    ``sax_node: [c_N, w] uint8`` → ``[w] float64``.
    """
    mids = region_midpoints(b)
    vals = mids[sax_node.astype(np.int64)]          # [c_N, w]
    return vals.var(axis=0)


def weighted_segment_variances(words: np.ndarray, counts: np.ndarray,
                               b: int) -> np.ndarray:
    """:func:`segment_variances` from grouped rows: ``(unique word, count)``
    pairs instead of the raw ``[c_N, w]`` table.  Mathematically identical
    (population variance weighted by multiplicity); float summation order
    differs from the row-wise form at the ulp level.

    ``words: [U, w] uint8``, ``counts: [U]`` → ``[w] float64``.
    """
    mids = region_midpoints(b)
    vals = mids[np.asarray(words).astype(np.int64)]        # [U, w]
    cw = np.asarray(counts, np.float64)[:, None]
    total = float(cw.sum())
    mean = (cw * vals).sum(axis=0) / total
    return (cw * (vals - mean) ** 2).sum(axis=0) / total


def objective(child_sizes: np.ndarray, sum_var: float, lam: int,
              th: int, alpha: float) -> float:
    """Eq. 1 for one candidate plan.

    ``child_sizes`` — the ``2**lam`` child occupancy vector;
    ``sum_var`` — sum of the chosen segments' variances (Eq. 2);
    """
    fill = child_sizes / th
    sigma_f = float(fill.std())
    o = float((child_sizes > th).mean())
    return _score(sigma_f, o, sum_var, lam, alpha)


def _score(sigma_f: float, o: float, sum_var: float, lam: int,
           alpha: float) -> float:
    """Eq. 1 from a plan's fill-factor deviation ``sigma_f`` and overflow
    share ``o``."""
    proximity = math.exp(math.sqrt(max(sum_var, 0.0) / lam))
    compactness = alpha * math.exp(-(1.0 + o) * sigma_f)
    return proximity + compactness


def _occupied(hist: np.ndarray, m: int) -> tuple[list, np.ndarray]:
    """The occupied codes of an ``m``-bit histogram as per-bit columns
    (MSB first) and their counts: what :func:`_fold` marginalizes."""
    nz = np.flatnonzero(hist)
    return [(nz >> (m - 1 - i)) & 1 for i in range(m)], hist[nz]


def _fold(occ: tuple[list, np.ndarray], keep: tuple[int, ...],
          dtype) -> np.ndarray:
    """Child sizes of plan ``keep`` from :func:`_occupied`'s codes: the
    counts are integers, so the sums are exact and equal a dense
    reshape-and-sum's."""
    bitcols, w = occ
    sub = np.zeros(len(w), np.int64)
    for pos in keep:
        sub = (sub << 1) | bitcols[pos]
    return np.bincount(sub, weights=w, minlength=1 << len(keep)).astype(dtype)


def _marginalize(hist: np.ndarray, m: int, keep: tuple[int, ...]) -> np.ndarray:
    """Child sizes of plan ``keep`` from an ``m``-bit parent histogram.

    Axis 0 = MSB.  Sums over the dropped bit positions; returns ``2**len(keep)``.
    """
    if len(keep) == m:
        return hist
    return _fold(_occupied(hist, m), keep, hist.dtype)


def choose_split_plan(base_hist: np.ndarray,
                      seg_vars: np.ndarray,
                      candidate_segments: list[int],
                      c_n: int,
                      params: SplitParams) -> tuple[int, ...]:
    """Algorithm 2 ``calcDist``: pick the best ``csl`` (segment ids, ascending).

    ``base_hist`` — ``2**m`` histogram of next-bit codes over
    ``candidate_segments`` (bit i of the code = segment ``candidate_segments[i]``,
    MSB first);
    ``seg_vars`` — per-segment variances aligned with ``candidate_segments``;
    ``c_n`` — node size.

    Returns the chosen segment ids (a tuple, ascending).  The DFS evaluates
    each plan once (``visit`` memoization), deriving every child-size vector
    from its parent plan's histogram rather than rescanning series.  Plans
    are scored in batches of equal arity: a row's ``std`` and ``mean`` in a
    stacked ``[plans, 2**lam]`` array are bitwise its own, and the batches
    are read in visit order, so the first plan of the best score wins, as
    with one :func:`objective` a plan.
    """
    m = len(candidate_segments)
    if m == 0:
        raise ValueError("no splittable segments")
    if m == 1:
        return (candidate_segments[0],)
    lam_min, lam_max = lambda_range(c_n, params.th, params.f_low, params.f_high, m)

    th, alpha = params.th, params.alpha
    visit: set[tuple[int, ...]] = set()
    best_score = -math.inf
    best_plan: tuple[int, ...] = (0,)
    evals = 0

    pending: list[tuple[tuple[int, ...], np.ndarray]] = []
    held = 0

    def flush() -> None:
        nonlocal best_score, best_plan, held
        sigma = np.empty(len(pending))
        over = np.empty(len(pending))
        by_lam: dict[int, list[int]] = {}
        for i, (keep, _) in enumerate(pending):
            by_lam.setdefault(len(keep), []).append(i)
        for rows in by_lam.values():
            H = np.stack([pending[i][1] for i in rows])
            sigma[rows] = (H / th).std(axis=1)
            over[rows] = (H > th).mean(axis=1)
        for (keep, _), sf, o in zip(pending, sigma, over):
            score = _score(float(sf), float(o),
                           float(seg_vars[list(keep)].sum()), len(keep),
                           alpha)
            if score > best_score:
                best_score = score
                best_plan = keep
        pending.clear()
        held = 0

    def consider(keep: tuple[int, ...], hist: np.ndarray) -> None:
        nonlocal evals, held
        evals += 1
        pending.append((keep, hist))
        held += hist.size
        if held >= 1 << 22:
            flush()

    def dfs(keep: tuple[int, ...], hist: np.ndarray) -> None:
        """Recurse to sub-plans of size ``len(keep)-1`` by dropping one bit."""
        nonlocal evals
        lam = len(keep)
        if lam - 1 < lam_min or evals > params.max_eval_plans:
            return
        for drop_pos in range(lam):
            sub = keep[:drop_pos] + keep[drop_pos + 1:]
            if sub in visit:
                continue
            visit.add(sub)
            sub_hist = hist.reshape((2,) * lam).sum(axis=drop_pos).reshape(-1)
            consider(sub, sub_hist)
            dfs(sub, sub_hist)

    # Top level: all lam_max-subsets, marginalized straight from the base
    # histogram's occupied codes; then DFS downward reusing each parent's
    # histogram.
    occ = _occupied(base_hist, m)
    for combo in itertools.combinations(range(m), lam_max):
        if evals > params.max_eval_plans:
            break
        if combo in visit:
            continue
        visit.add(combo)
        hist = (base_hist if lam_max == m
                else _fold(occ, combo, base_hist.dtype))
        consider(combo, hist)
        dfs(combo, hist)
    flush()

    return tuple(sorted(candidate_segments[i] for i in best_plan))


def plan_split(codes: np.ndarray,
               weights: np.ndarray,
               seg_vars: np.ndarray,
               candidate_segments: list[int],
               c_n: int,
               params: SplitParams) -> tuple[tuple[int, ...], int]:
    """Algorithm 2 over *grouped* prefixes: the optimized evaluator used by
    the bottom-up device build (``core/build_device.py``).

    Where :func:`choose_split_plan` marginalizes one per-row ``2**m``
    histogram, this takes ``(next-bit code, multiplicity)`` pairs — one entry
    per distinct SAX word in the node, so per-plan cost scales with the
    number of distinct words, not rows.  Child-size histograms are exact
    integers either way, and the same :func:`objective` decides, so the two
    evaluators agree except on exact score ties: plans are enumerated here in
    ``lambda``-ascending / lexicographic order (the
    :func:`brute_force_split_plan` order) with strict improvement, while the
    DFS of ``choose_split_plan`` visits plans in a different order and may
    keep a different member of a tied set (the documented tie-breaking of
    the build-backend parity contract — see ``docs/build_pipeline.md``).

    ``codes`` — ``m``-bit next-bit codes (bit i = ``candidate_segments[i]``,
    MSB first), one per distinct word (need not be unique: aggregated here);
    ``weights`` — multiplicities aligned with ``codes``;
    ``seg_vars`` — per-segment variances aligned with ``candidate_segments``.

    Returns ``(csl ascending, n_plans_evaluated)``.
    """
    m = len(candidate_segments)
    if m == 0:
        raise ValueError("no splittable segments")
    if m == 1:
        return (candidate_segments[0],), 0
    lam_min, lam_max = lambda_range(c_n, params.th, params.f_low,
                                    params.f_high, m)
    codes = np.asarray(codes, np.int64)
    uc, inv = np.unique(codes, return_inverse=True)
    uw = np.bincount(inv, weights=np.asarray(weights, np.float64))
    th, alpha = params.th, params.alpha
    svp = np.asarray(seg_vars, np.float64)

    n_plans = sum(math.comb(m, lam) for lam in range(lam_min, lam_max + 1))
    if n_plans > params.max_eval_plans:
        # Safety valve (never binds for w <= 17): evaluate plans one at a
        # time in enumeration order until the cap, folding each histogram
        # directly from the aggregated codes.
        best_score, best_plan, evals = -math.inf, (0,), 0
        bitcols = [(uc >> (m - 1 - i)) & 1 for i in range(m)]
        for lam in range(lam_min, lam_max + 1):
            for combo in itertools.combinations(range(m), lam):
                if evals >= params.max_eval_plans:
                    break
                sub = bitcols[combo[0]]
                for pos in combo[1:]:
                    sub = (sub << 1) | bitcols[pos]
                hist = np.bincount(sub, weights=uw, minlength=1 << lam)
                score = objective(hist, float(svp[list(combo)].sum()), lam,
                                  th, alpha)
                evals += 1
                if score > best_score:
                    best_score, best_plan = score, combo
        return tuple(sorted(candidate_segments[i] for i in best_plan)), evals

    # Per-level histograms: the top (lam_max) level is folded directly from
    # the aggregated codes; every lower level is a one-axis marginalization
    # of a parent plan at the level above (Alg. 2 speedup 3, level-wise).
    bitcols = [(uc >> (m - 1 - i)) & 1 for i in range(m)]
    levels: dict[int, tuple[list[tuple[int, ...]], np.ndarray]] = {}
    combos_top = list(itertools.combinations(range(m), lam_max))
    H = np.empty((len(combos_top), 1 << lam_max), np.float64)
    for t, combo in enumerate(combos_top):
        sub = bitcols[combo[0]]
        for pos in combo[1:]:
            sub = (sub << 1) | bitcols[pos]
        H[t] = np.bincount(sub, weights=uw, minlength=1 << lam_max)
    levels[lam_max] = (combos_top, H)
    for lam in range(lam_max - 1, lam_min - 1, -1):
        p_combos, pH = levels[lam + 1]
        p_idx = {cb: t for t, cb in enumerate(p_combos)}
        combos = list(itertools.combinations(range(m), lam))
        pidx = np.empty(len(combos), np.int64)
        dpos = np.empty(len(combos), np.int64)
        for t, cb in enumerate(combos):
            cbs = set(cb)
            x = next(j for j in range(m) if j not in cbs)
            parent = tuple(sorted(cb + (x,)))
            pidx[t] = p_idx[parent]
            dpos[t] = parent.index(x)
        H = np.empty((len(combos), 1 << lam), np.float64)
        for dp in range(lam + 1):
            sel = np.flatnonzero(dpos == dp)
            if not len(sel):
                continue
            sub = pH[pidx[sel]].reshape((len(sel),) + (2,) * (lam + 1))
            H[sel] = sub.sum(axis=1 + dp).reshape(len(sel), -1)
        levels[lam] = (combos, H)

    # Evaluate lambda-ascending; np.argmax keeps the first (lexicographically
    # smallest) maximum within a level, strict > keeps the earlier level.
    best_score, best_plan, evals = -math.inf, (0,), 0
    for lam in range(lam_min, lam_max + 1):
        combos, H = levels[lam]
        sv = svp[np.asarray(combos, np.int64)].sum(axis=1)
        prox = np.exp(np.sqrt(np.maximum(sv, 0.0) / lam))
        sigma_f = (H / th).std(axis=1)
        o = (H > th).mean(axis=1)
        scores = prox + alpha * np.exp(-(1.0 + o) * sigma_f)
        evals += len(combos)
        k = int(np.argmax(scores))
        if float(scores[k]) > best_score:
            best_score, best_plan = float(scores[k]), combos[k]
    return tuple(sorted(candidate_segments[i] for i in best_plan)), evals


def brute_force_split_plan(base_hist: np.ndarray,
                           seg_vars: np.ndarray,
                           candidate_segments: list[int],
                           c_n: int,
                           params: SplitParams) -> tuple[int, ...]:
    """Oracle: evaluate *every* plan in the lambda band directly from the base
    histogram.  Used by tests to certify the DFS explores the same optimum."""
    m = len(candidate_segments)
    lam_min, lam_max = lambda_range(c_n, params.th, params.f_low, params.f_high, m)
    best, best_plan = -math.inf, None
    for lam in range(lam_min, lam_max + 1):
        for combo in itertools.combinations(range(m), lam):
            hist = _marginalize(base_hist, m, combo)
            s = objective(hist, float(seg_vars[list(combo)].sum()), lam,
                          params.th, params.alpha)
            if s > best:
                best, best_plan = s, combo
    return tuple(sorted(candidate_segments[i] for i in best_plan))
