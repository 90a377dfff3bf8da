"""TARDIS-style full-ary index (paper's full-fanout competitor [68]); copy
of ``repro.core.baselines.tardis``.

Every split refines *all* still-refinable segments (fanout up to 2**w), which
preserves proximity but produces the paper's Table-1 pathology: millions of
near-empty leaves.  Leaves are then grouped into *size-based partitions*
(the 128MB packs of [68]) that ignore SAX adjacency, so a partition's iSAX
word collapses to its parent's word — the pruning-power loss the paper
criticizes in §5.4 is reproduced faithfully.
"""
from __future__ import annotations

import numpy as np

from ..build import BuildStats, DumpyParams, TreeNode, collect_leaves
from ..index import DumpyIndex, flatten_tree
from ..sax import next_bits_np, pack_bits_np, sax_encode_np
from .isax2plus import _finalize


def build_tardis(db: np.ndarray, params: DumpyParams) -> DumpyIndex:
    db = np.ascontiguousarray(db, np.float32)
    paa, sax = sax_encode_np(db, params.sax)
    w, b, th = params.sax.w, params.sax.b, params.th
    n = db.shape[0]
    stats = BuildStats(n_series=n)

    root = TreeNode(np.zeros(w, np.int64), np.zeros(w, np.int64), 0)
    root.size = n
    ids = np.arange(n, dtype=np.int64)

    def split(node: TreeNode, node_ids: np.ndarray) -> None:
        avail = [j for j in range(w) if node.card[j] < b]
        if not avail:
            node.series_ids = node_ids
            return
        csl = tuple(avail)                      # full-ary: all segments
        node.csl = csl
        lam = len(csl)
        bits = next_bits_np(sax[node_ids][:, avail], node.card[avail], b)
        sids = pack_bits_np(bits)
        order = np.argsort(sids, kind="stable")
        s_sorted = sids[order]
        uniq, starts = np.unique(s_sorted, return_index=True)
        bounds = np.append(starts, len(s_sorted))
        for i, sid in enumerate(uniq):
            child_ids = node_ids[order[bounds[i]:bounds[i + 1]]]
            sym, card = node.sym.copy(), node.card.copy()
            for pos, seg in enumerate(csl):
                bit = (int(sid) >> (lam - 1 - pos)) & 1
                sym[seg] = (sym[seg] << 1) | bit
                card[seg] += 1
            child = TreeNode(sym, card, node.depth + 1)
            child.size = len(child_ids)
            node.children[int(sid)] = child
            node.routing[int(sid)] = child
            if len(child_ids) > th:
                split(child, child_ids)
            else:
                child.series_ids = child_ids
        _size_partition(node, th)

    def _size_partition(node: TreeNode, cap: int) -> None:
        """Size-only greedy packing of leaf children into partitions whose
        iSAX word is the (coarse) parent word — no demotion-bit constraint."""
        leaf_sids = sorted(s for s, c in node.children.items() if c.is_leaf)
        cur_ids, cur_sids, cur_size = [], [], 0
        for s in leaf_sids:
            c = node.children[s]
            if cur_size + c.size > cap and cur_ids:
                _emit(node, cur_sids, cur_ids)
                cur_ids, cur_sids, cur_size = [], [], 0
            cur_ids.append(c.series_ids)
            cur_sids.append(s)
            cur_size += c.size
        if cur_ids:
            _emit(node, cur_sids, cur_ids)

    def _emit(node: TreeNode, sids: list[int], ids_list: list[np.ndarray]) -> None:
        if len(sids) == 1:
            return                                    # keep as-is
        part = TreeNode(node.sym.copy(), node.card.copy(), node.depth + 1)
        part.series_ids = np.concatenate(ids_list)
        part.size = len(part.series_ids)
        part.is_pack = True
        for s in sids:
            node.children[s] = part
            node.routing[s] = part

    if n <= th:
        root.series_ids = ids
    else:
        split(root, ids)

    _finalize(root, stats)
    leaves = collect_leaves(root)
    stats.fill_factor = (float(np.mean([l.size for l in leaves])) / th
                         if leaves else 0.0)
    flat = flatten_tree(root, b)
    return DumpyIndex(params, root, flat, db, paa, sax, stats)
