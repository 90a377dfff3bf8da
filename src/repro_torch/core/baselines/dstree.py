"""DSTree-style index (paper's non-SAX competitor [65]); copy of
``repro.core.baselines.dstree``, whose search is host code in both packages.

EAPCA summarization: each node keeps, per time-segment, the (min/max mean,
min/max std) envelope of its members.  Splits are chosen by a QoS-style
heuristic over candidate (segment × mean-or-std) hyperplanes, including the
*vertical* split that subdivides a segment (the dynamic-segmentation feature
that gives DSTree its accuracy and its long build times — every split must
touch raw data, which is why the paper finds it ~5x slower to build).

Lower bound (EAPCA):  for series s in node with per-segment envelopes,
``ED^2(q,s) >= Σ_seg len·(dist(μq,[μmin,μmax])^2 + dist(σq,[σmin,σmax])^2)``.

This is a functional reproduction of the mechanism (summarization, split
policy shape, lower bound), not a line-by-line port of the original C code.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..search import SearchStats, _merge_topk, _heap_result
from ..lb import ed_np


@dataclasses.dataclass
class _Seg:
    start: int
    end: int            # exclusive


class DSTreeNode:
    __slots__ = ("segs", "mu_lo", "mu_hi", "sd_lo", "sd_hi", "size", "depth",
                 "split_rule", "left", "right", "series_ids", "leaf_id", "n_leaves")

    def __init__(self, segs: list[_Seg], depth: int):
        self.segs = segs
        self.mu_lo = self.mu_hi = self.sd_lo = self.sd_hi = None
        self.size = 0
        self.depth = depth
        self.split_rule = None       # (seg_idx, 'mean'|'std', threshold)
        self.left = self.right = None
        self.series_ids = None
        self.leaf_id = -1
        self.n_leaves = 0

    @property
    def is_leaf(self) -> bool:
        return self.split_rule is None


def _seg_stats(db: np.ndarray, ids: np.ndarray, segs: list[_Seg]):
    mus = np.stack([db[ids, s.start:s.end].mean(axis=1) for s in segs], axis=1)
    sds = np.stack([db[ids, s.start:s.end].std(axis=1) for s in segs], axis=1)
    return mus, sds


def _range_reduction(vals: np.ndarray) -> tuple[float, float]:
    """QoS surrogate: split at the mean; gain = parent range^2 − mean of child
    ranges^2 (how much the envelope tightens)."""
    t = float(vals.mean())
    lo, hi = vals.min(), vals.max()
    left, right = vals[vals <= t], vals[vals > t]
    if len(left) == 0 or len(right) == 0:
        return -np.inf, t
    r_parent = (hi - lo) ** 2
    r_kids = ((left.max() - left.min()) ** 2 + (right.max() - right.min()) ** 2) / 2
    return r_parent - r_kids, t


class DSTreeIndex:
    def __init__(self, db: np.ndarray, th: int, init_segments: int = 4,
                 max_segments: int = 16):
        self.db = np.ascontiguousarray(db, np.float32)
        self.th = th
        self.max_segments = max_segments
        n = db.shape[0]
        length = db.shape[1]
        width = length // init_segments
        segs = [_Seg(i * width, (i + 1) * width if i < init_segments - 1 else length)
                for i in range(init_segments)]
        self.root = DSTreeNode(segs, 0)
        self.root.size = n
        self.n_nodes = 0
        self.stats_raw_touches = 0      # raw-series passes (build-cost proxy)
        self._build(self.root, np.arange(n, dtype=np.int64))
        self.n_leaves = self._finalize(self.root)
        leaves = self._leaves(self.root)
        self.fill_factor = float(np.mean([len(l.series_ids) for l in leaves])) / th
        self.height = max(l.depth for l in leaves)

    # -- build ----------------------------------------------------------------
    def _build(self, node: DSTreeNode, ids: np.ndarray) -> None:
        self.n_nodes += 1
        mus, sds = _seg_stats(self.db, ids, node.segs)
        self.stats_raw_touches += len(ids)
        node.mu_lo, node.mu_hi = mus.min(axis=0), mus.max(axis=0)
        node.sd_lo, node.sd_hi = sds.min(axis=0), sds.max(axis=0)
        node.size = len(ids)
        if len(ids) <= self.th:
            node.series_ids = ids
            return

        # candidate splits: (seg, mean), (seg, std) + vertical subdivisions
        best = (-np.inf, None, None, None)   # gain, rule, segs_after, mask
        for si, seg in enumerate(node.segs):
            for kind, vals in (("mean", mus[:, si]), ("std", sds[:, si])):
                gain, t = _range_reduction(vals)
                if gain > best[0]:
                    best = (gain, (si, kind, t), node.segs, vals <= t)
            if (len(node.segs) < self.max_segments
                    and seg.end - seg.start >= 2):       # vertical split
                mid = (seg.start + seg.end) // 2
                sub = self.db[ids, seg.start:mid].mean(axis=1)
                self.stats_raw_touches += len(ids)       # raw-data pass!
                gain, t = _range_reduction(sub)
                gain *= 1.25   # DSTree favours segmentation refinement
                if gain > best[0]:
                    new_segs = (node.segs[:si] + [_Seg(seg.start, mid),
                                                  _Seg(mid, seg.end)]
                                + node.segs[si + 1:])
                    best = (gain, (si, "vmean", t), new_segs, sub <= t)
        gain, rule, segs_after, mask = best
        if rule is None or not (0 < mask.sum() < len(ids)):
            node.series_ids = ids
            return
        node.split_rule = rule
        node.segs = segs_after
        node.left = DSTreeNode(segs_after, node.depth + 1)
        node.right = DSTreeNode(segs_after, node.depth + 1)
        self._build(node.left, ids[mask])
        self._build(node.right, ids[~mask])

    def _finalize(self, node: DSTreeNode) -> int:
        if node.is_leaf:
            node.n_leaves = 1
            return 1
        node.n_leaves = self._finalize(node.left) + self._finalize(node.right)
        return node.n_leaves

    def _leaves(self, node: DSTreeNode) -> list[DSTreeNode]:
        if node.is_leaf:
            return [node]
        return self._leaves(node.left) + self._leaves(node.right)

    # -- lower bound ------------------------------------------------------------
    def _lb(self, node: DSTreeNode, q: np.ndarray) -> float:
        total = 0.0
        for si, seg in enumerate(node.segs):
            ln = seg.end - seg.start
            quad = q[seg.start:seg.end]
            mq, sq = quad.mean(), quad.std()
            dmu = max(0.0, node.mu_lo[si] - mq, mq - node.mu_hi[si])
            dsd = max(0.0, node.sd_lo[si] - sq, sq - node.sd_hi[si])
            total += ln * (dmu * dmu + dsd * dsd)
        return float(np.sqrt(total))

    # -- search -----------------------------------------------------------------
    def _route(self, q: np.ndarray) -> DSTreeNode:
        node = self.root
        while not node.is_leaf:
            si, kind, t = node.split_rule
            seg = node.segs[si]
            if kind == "mean":
                v = q[seg.start:seg.end].mean()
            elif kind == "std":
                v = q[seg.start:seg.end].std()
            else:  # vmean — segment was subdivided; use its left half
                v = q[seg.start:seg.end].mean()
            node = node.left if v <= t else node.right
        return node

    def approximate_search(self, q: np.ndarray, k: int):
        leaf = self._route(q)
        d = ed_np(q, self.db[leaf.series_ids])
        heap: list = []
        alive = np.ones(self.db.shape[0], bool)
        _merge_topk(heap, leaf.series_ids, d, alive, k)
        ids, dd = _heap_result(heap)
        return ids, dd, SearchStats(leaves_visited=1, series_scanned=leaf.size)

    def extended_search(self, q: np.ndarray, k: int, nbr: int):
        leaves = self._leaves(self.root)
        leaves.sort(key=lambda l: self._lb(l, q))
        heap: list = []
        alive = np.ones(self.db.shape[0], bool)
        st = SearchStats()
        for leaf in leaves[:nbr]:
            d = ed_np(q, self.db[leaf.series_ids])
            _merge_topk(heap, leaf.series_ids, d, alive, k)
            st.leaves_visited += 1
            st.series_scanned += leaf.size
        st.pruning_ratio = 1 - st.leaves_visited / max(self.n_leaves, 1)
        ids, dd = _heap_result(heap)
        return ids, dd, st

    def exact_search(self, q: np.ndarray, k: int):
        ids0, d0, _ = self.approximate_search(q, k)
        heap: list = []
        alive = np.ones(self.db.shape[0], bool)
        _merge_topk(heap, ids0, d0, alive, k)
        leaves = self._leaves(self.root)
        lbs = np.array([self._lb(l, q) for l in leaves])
        order = np.argsort(lbs)
        st = SearchStats(leaves_visited=1)
        kth = -heap[0][0] if len(heap) == k else np.inf
        for li in order:
            if lbs[li] >= kth:
                break
            leaf = leaves[li]
            d = ed_np(q, self.db[leaf.series_ids])
            _merge_topk(heap, leaf.series_ids, d, alive, k)
            st.leaves_visited += 1
            st.series_scanned += leaf.size
            kth = -heap[0][0] if len(heap) == k else np.inf
        st.pruning_ratio = 1 - st.leaves_visited / max(self.n_leaves, 1)
        ids, dd = _heap_result(heap)
        return ids, dd, st
