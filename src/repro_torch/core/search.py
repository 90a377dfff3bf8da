"""Query answering on the host (paper §5.5): approximate, extended
approximate (Alg. 4) and exact kNN with lower-bound pruning, under ED and
DTW — the port's numpy copy of ``repro.core.search``.

Host code orchestrates leaf visit order (the analogue of disk scheduling)
with numpy math over the port's own ``core`` modules; the same data and
parameters give bitwise the reference's ids, distances and visit counts.
It is the host reference the batched device paths in ``search_device``
are held against.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from .build import TreeNode
from .index import DumpyIndex
from .lb import dtw_np, ed_np, lb_keogh_np, node_bounds_np
from .metric import Metric, interval_mindist_np, query_prep_np, resolve
from .sax import sax_encode_np


@dataclasses.dataclass
class SearchStats:
    leaves_visited: int = 0
    series_scanned: int = 0
    pruning_ratio: float = 0.0


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _encode_query(index: DumpyIndex, q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    paa, sax = sax_encode_np(q.reshape(1, -1), index.params.sax)
    return paa[0], sax[0]


def _leaf_candidates(index: DumpyIndex, leaf_id: int) -> tuple[np.ndarray, np.ndarray]:
    """(original ids, raw series) of one leaf pack — a contiguous slab."""
    lo = index.flat.leaf_offsets[leaf_id]
    hi = index.flat.leaf_offsets[leaf_id + 1]
    ids = index.flat.order[lo:hi]
    return ids, index.db_ordered[lo:hi]


def _dists(q: np.ndarray, xs: np.ndarray, metric: Metric) -> np.ndarray:
    if not metric.is_dtw:
        return ed_np(q, xs)
    return np.array([dtw_np(q, x, metric.band) for x in xs])


def _merge_topk(heap: list, ids: np.ndarray, dists: np.ndarray, alive: np.ndarray,
                k: int) -> None:
    """Maintain a max-heap of (−dist, id) with per-id dedup (fuzzy duplicates)."""
    seen = {i for _, i in heap}
    for d, i in zip(dists, ids):
        i = int(i)
        if not alive[i] or i in seen:
            continue
        if len(heap) < k:
            heapq.heappush(heap, (-float(d), i))
            seen.add(i)
        elif -heap[0][0] > d:
            heapq.heappushpop(heap, (-float(d), i))
            seen.add(i)


def _heap_result(heap: list) -> tuple[np.ndarray, np.ndarray]:
    pairs = sorted([(-nd, i) for nd, i in heap])
    return (np.array([i for _, i in pairs], np.int64),
            np.array([d for d, _ in pairs], np.float32))


def _node_lb(node: TreeNode, qseg: tuple, n: int, b: int) -> float:
    """Metric-generic node lower bound: ``qseg = (seg_lo, seg_hi)`` is the
    query's per-segment interval (degenerate = ED MINDIST, envelope summary
    = DTW bound — see ``core.metric``)."""
    lo, hi = node_bounds_np(node.sym[None, :], node.card[None, :], b)
    return float(interval_mindist_np(qseg[0], qseg[1], lo, hi, n)[0])


# ---------------------------------------------------------------------------
# approximate search — one target leaf (paper §5.5)
# ---------------------------------------------------------------------------

def route_to_leaf(index: DumpyIndex, paa_q: np.ndarray, sax_q: np.ndarray,
                  qseg: tuple | None = None) -> TreeNode:
    """Root→leaf descent of one query (paper §5.5).  Empty regions fall back
    to the most promising existing child by the metric's node bound
    (``qseg`` interval; ED when omitted).  This is the host reference for
    the vectorized descent in ``search_device``."""
    b, n = index.params.sax.b, index.n
    if qseg is None:
        qseg = (paa_q, paa_q)
    node = index.root
    while not node.is_leaf:
        sid = node.route_sid(sax_q, b)
        child = node.routing.get(sid) or node.children.get(sid)
        if child is None:   # empty region → most promising existing child
            child = min(node.children.values(),
                        key=lambda c: _node_lb(c, qseg, n, b))
        node = child
    return node


def approximate_search(index: DumpyIndex, q: np.ndarray, k: int,
                       metric: str = "ed", band: int | None = None
                       ) -> tuple[np.ndarray, np.ndarray, SearchStats]:
    paa_q, sax_q = _encode_query(index, q)
    met = resolve(metric, index.n, band)
    seg_lo, seg_hi, _, _ = query_prep_np(met, q, paa_q)
    node = route_to_leaf(index, paa_q, sax_q, qseg=(seg_lo, seg_hi))
    ids, xs = _leaf_candidates(index, node.leaf_id)
    heap: list = []
    _merge_topk(heap, ids, _dists(q, xs, met), index.alive, k)
    stats = SearchStats(leaves_visited=1, series_scanned=len(ids),
                        pruning_ratio=1.0 - 1.0 / max(index.flat.n_leaves, 1))
    rid, rd = _heap_result(heap)
    return rid, rd, stats


# ---------------------------------------------------------------------------
# extended approximate search — Algorithm 4
# ---------------------------------------------------------------------------

def extended_search(index: DumpyIndex, q: np.ndarray, k: int, nbr: int,
                    metric: str = "ed", band: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray, SearchStats]:
    """Extended approximate search (paper Alg. 4): widen the approximate
    answer to lower-bound-ordered *sibling subtrees* of the target.

    Visit schedule (mirrored bit-for-bit by the batched device path in
    ``search_device.extended_search_device_batch``):

    1. descend by sid while the current subtree holds more than ``nbr``
       leaves; empty regions fall back to the min-LB child exactly like
       ``route_to_leaf`` (the old dead-end descent stopped with a stale
       parent and an arbitrary sibling set);
    2. the target subtree is visited *first* and completely (it holds at
       most ``nbr`` leaves, so with ``nbr=1`` this degenerates bitwise to
       ``approximate_search`` — and growing ``nbr`` only ever adds leaves,
       which makes the k-th distance monotone in ``nbr``);
    3. the remaining siblings follow ordered by (MINDIST, leaf span), and
       inside every subtree leaves are visited by (MINDIST, leaf id) — the
       node ordering Alg. 4 prescribes (leaves used to be visited in
       arbitrary traversal order) — until ``nbr`` leaves have been read.

    All node bounds use the metric's interval MINDIST (ED: degenerate PAA
    interval; DTW: LB_Keogh envelope summary), so the visit schedule is
    metric-consistent with the exact search's leaf ordering.
    """
    paa_q, sax_q = _encode_query(index, q)
    b, n = index.params.sax.b, index.n
    met = resolve(metric, n, band)
    seg_lo, seg_hi, _, _ = query_prep_np(met, q, paa_q)
    qseg = (seg_lo, seg_hi)
    nbr = max(int(nbr), 1)

    parent, node = None, index.root
    while not node.is_leaf and node.n_leaves > nbr:
        sid = node.route_sid(sax_q, b)
        child = node.routing.get(sid) or node.children.get(sid)
        if child is None:   # empty region → most promising existing child
            child = min(node.children.values(),
                        key=lambda c: _node_lb(c, qseg, n, b))
        parent, node = node, child

    ordered: list[TreeNode]
    if parent is None:          # whole tree is within budget
        ordered = [node]
    else:
        seen: set[int] = {id(node)}
        siblings: list[TreeNode] = []
        for c in parent.children.values():
            if id(c) not in seen:
                seen.add(id(c))
                siblings.append(c)
        siblings.sort(key=lambda c: (_node_lb(c, qseg, n, b),
                                     _subtree_begin(c)))
        ordered = [node] + siblings

    heap: list = []
    stats = SearchStats()
    for sub in ordered:
        if stats.leaves_visited >= nbr:
            break
        leaves = sorted(_leaves_under(sub),
                        key=lambda lf: (_node_lb(lf, qseg, n, b),
                                        lf.leaf_id))
        for leaf in leaves:
            if stats.leaves_visited >= nbr:
                break
            ids, xs = _leaf_candidates(index, leaf.leaf_id)
            _merge_topk(heap, ids, _dists(q, xs, met), index.alive, k)
            stats.leaves_visited += 1
            stats.series_scanned += len(ids)
    stats.pruning_ratio = 1.0 - stats.leaves_visited / max(index.flat.n_leaves, 1)
    rid, rd = _heap_result(heap)
    return rid, rd, stats


def _leaves_under(node: TreeNode) -> list[TreeNode]:
    out, seen = [], set()

    def rec(x: TreeNode) -> None:
        if id(x) in seen:
            return
        seen.add(id(x))
        if x.is_leaf:
            out.append(x)
        else:
            for c in x.children.values():
                rec(c)

    rec(node)
    return out


def _subtree_begin(node: TreeNode) -> int:
    """Smallest leaf id under ``node`` — the unique sibling tie-break key
    (subtree leaf spans are contiguous and disjoint, see
    ``index._subtree_spans``)."""
    return min(lf.leaf_id for lf in _leaves_under(node))


# ---------------------------------------------------------------------------
# exact search — lower-bound pruning (paper §5.5/§7.2.2)
# ---------------------------------------------------------------------------

def exact_search(index: DumpyIndex, q: np.ndarray, k: int,
                 metric: str = "ed", band: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray, SearchStats]:
    n = index.n
    met = resolve(metric, n, band)
    paa_q, _ = _encode_query(index, q)
    seg_lo, seg_hi, env_lo, env_hi = query_prep_np(met, q, paa_q)

    # 1) seed best-so-far from the approximate answer
    ids0, d0, _ = approximate_search(index, q, k, met)
    heap: list = []
    _merge_topk(heap, ids0, d0, index.alive, k)

    # 2) lower bounds to every leaf pack — the metric's interval MINDIST
    lbs = interval_mindist_np(seg_lo, seg_hi, index.flat.leaf_lo,
                              index.flat.leaf_hi, n)

    order = np.argsort(lbs, kind="stable")
    stats = SearchStats(leaves_visited=1)
    kth = (-heap[0][0]) if len(heap) == k else np.inf
    for leaf_id in order:
        if lbs[leaf_id] >= kth:
            break                       # sorted ⇒ everything further prunes
        ids, xs = _leaf_candidates(index, int(leaf_id))
        if met.is_dtw:
            # candidate-level LB_Keogh pre-filter (the device path's
            # `lb_keogh` kernel): only survivors pay the O(n·band) exact DTW
            lbk = lb_keogh_np(xs, env_hi, env_lo)
            sel = lbk < kth
            d = np.full(len(ids), np.inf)
            if sel.any():
                d[sel] = _dists(q, xs[sel], met)
            stats.series_scanned += int(sel.sum())
        else:
            d = _dists(q, xs, met)
            stats.series_scanned += len(ids)
        _merge_topk(heap, ids, d, index.alive, k)
        stats.leaves_visited += 1
        kth = (-heap[0][0]) if len(heap) == k else np.inf
    stats.pruning_ratio = 1.0 - stats.leaves_visited / max(index.flat.n_leaves, 1)
    rid, rd = _heap_result(heap)
    return rid, rd, stats


# ---------------------------------------------------------------------------
# evaluation measures (paper §7 [Measures])
# ---------------------------------------------------------------------------

def average_precision(approx_ids: np.ndarray, exact_ids: np.ndarray) -> float:
    """AP = (1/k) Σ_i P(q,i)·rel(i); rel(i)=1 iff the i-th result is a true
    neighbor; P(q,i) = precision among the top-i."""
    k = len(exact_ids)
    truth = set(int(i) for i in exact_ids)
    hits, ap = 0, 0.0
    for i, a in enumerate(approx_ids[:k], start=1):
        rel = int(a) in truth
        hits += rel
        if rel:
            ap += hits / i
    return ap / k


def error_ratio(approx_d: np.ndarray, exact_d: np.ndarray) -> float:
    """(1/k) Σ dist(a_i)/dist(r_i), guarding zero distances."""
    k = len(exact_d)
    num = np.asarray(approx_d[:k], np.float64)
    den = np.asarray(exact_d, np.float64)
    if len(num) < k:   # pad missing results with worst observed
        pad = np.full(k - len(num), num.max() if len(num) else 1.0)
        num = np.concatenate([num, pad])
    mask = den > 1e-12
    out = np.ones(k)
    out[mask] = num[mask] / den[mask]
    return float(out.mean())
