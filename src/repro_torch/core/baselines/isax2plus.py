"""iSAX2+-style binary index (paper's primary SAX-family competitor); copy
of ``repro.core.baselines.isax2plus``.

Structure: full fanout at the first layer (iSAX standard), binary splits
below.  Two faithful weaknesses the paper exploits are reproduced:

1. **Split-on-overflow statistics**: split decisions are made from the first
   ``th+1`` series that arrived in the node (paper §5.2 — "split once it is
   just full"), not the global distribution.
2. **Binary split policy**: choose the single segment whose series mean is
   closest to the would-be breakpoint (balance heuristic of iSAX2.0 [12]),
   which produces the skewed per-segment granularities of Fig. 2(a).

The builder shares Dumpy's TreeNode / flatten machinery so every search
algorithm and benchmark runs unchanged on top of it.
"""
from __future__ import annotations

import numpy as np

from ..build import BuildStats, DumpyParams, TreeNode, collect_leaves
from ..index import DumpyIndex, flatten_tree
from ..sax import breakpoints_ext, next_bits_np, pack_bits_np, region_midpoints, sax_encode_np


def _binary_split_segment(sax_probe: np.ndarray, sym: np.ndarray,
                          card: np.ndarray, b: int) -> int | None:
    """iSAX2.0 balance heuristic on the probe series (first th+1)."""
    w = sax_probe.shape[1]
    mids = region_midpoints(b)
    bpe = breakpoints_ext(b)
    best, best_seg = np.inf, None
    for j in range(w):
        if card[j] >= b:
            continue
        mu = mids[sax_probe[:, j].astype(np.int64)].mean()
        m_idx = ((int(sym[j]) << 1) | 1) << (b - int(card[j]) - 1)
        m = bpe[m_idx]
        if not np.isfinite(m):
            continue
        score = abs(mu - m)
        if score < best:
            best, best_seg = score, j
    return best_seg


def build_isax2plus(db: np.ndarray, params: DumpyParams) -> DumpyIndex:
    db = np.ascontiguousarray(db, np.float32)
    paa, sax = sax_encode_np(db, params.sax)
    w, b, th = params.sax.w, params.sax.b, params.th
    n = db.shape[0]
    stats = BuildStats(n_series=n)

    root = TreeNode(np.zeros(w, np.int64), np.zeros(w, np.int64), 0)
    root.size = n
    ids = np.arange(n, dtype=np.int64)

    def split(node: TreeNode, node_ids: np.ndarray, first_layer: bool) -> None:
        if first_layer:
            csl = tuple(j for j in range(w) if node.card[j] < b)
        else:
            probe = node_ids[:th + 1]                    # overflow-time stats
            seg = _binary_split_segment(sax[probe], node.sym, node.card, b)
            if seg is None:
                node.series_ids = node_ids
                node.csl = None
                return
            csl = (seg,)
        node.csl = csl
        lam = len(csl)
        bits = next_bits_np(sax[node_ids][:, list(csl)], node.card[list(csl)], b)
        sids = pack_bits_np(bits)
        for sid in np.unique(sids):
            child_ids = node_ids[sids == sid]
            sym, card = node.sym.copy(), node.card.copy()
            for pos, seg_ in enumerate(csl):
                bit = (int(sid) >> (lam - 1 - pos)) & 1
                sym[seg_] = (sym[seg_] << 1) | bit
                card[seg_] += 1
            child = TreeNode(sym, card, node.depth + 1)
            child.size = len(child_ids)
            node.children[int(sid)] = child
            node.routing[int(sid)] = child
            if len(child_ids) > th and not np.all(card >= b):
                split(child, child_ids, first_layer=False)
            else:
                child.series_ids = child_ids

    if n <= th:
        root.series_ids = ids
    else:
        split(root, ids, first_layer=True)

    _finalize(root, stats)
    leaves = collect_leaves(root)
    stats.fill_factor = (float(np.mean([l.size for l in leaves])) / th
                         if leaves else 0.0)
    flat = flatten_tree(root, b)
    return DumpyIndex(params, root, flat, db, paa, sax, stats)


def _finalize(node: TreeNode, stats: BuildStats) -> int:
    stats.n_nodes += 1
    stats.height = max(stats.height, node.depth)
    if node.is_leaf:
        stats.n_leaves += 1
        node.n_leaves = 1
        return 1
    total = 0
    seen: set[int] = set()
    for c in node.children.values():
        if id(c) in seen:
            continue
        seen.add(id(c))
        total += _finalize(c, stats)
    node.n_leaves = total
    return total
