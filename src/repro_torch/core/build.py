"""Dumpy index construction (paper §5.2, Algorithm 1) — numpy copy of
``repro.core.build`` (the port carries its own: the reference module reaches
JAX through ``repro.core.sax``).

The build is a staged pipeline shared by two backends:

  Stage 1  encode the whole collection → (PAA, SAX) tables
  Stage 2  group — identify the rows (host: row partition per node; device:
           lexsorted distinct-SAX-word groups, ``core/build_device.py``)
  Stage 3  adaptive split plan (Algorithm 2) — :func:`plan_node_rows` is the
           reference evaluator over raw rows, :func:`plan_node_grouped` the
           optimized evaluator over (word, multiplicity) pairs
  Stage 4  leaf-node packing (Algorithm 3) — :func:`pack_siblings`
  Stage 5  materialization — a permutation of the collection into
           leaf-contiguous (CSR) layout instead of buffered disk flushes

``DumpyBuilder`` is the host backend: a breadth-first driver over
:meth:`_split_node`, the staged recursion body.  The device backend
(``core/build_device.py``) runs the same stages bottom-up over grouped SAX
words and shares :func:`pack_siblings` / the split objective, so the two
backends produce the same layout up to the documented tie-breaking
(``docs/build_pipeline.md``).  Both drivers expand the frontier
breadth-first so the fuzzy replica-budget consumption order is identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import fuzzy as fuzzy_mod
from .pack import Pack, pack_isax, pack_leaves
from .sax import (SaxParams, next_bits_np, pack_bits_np, sax_encode_np)
from .split import (SplitParams, choose_split_plan, plan_split,
                    segment_variances, weighted_segment_variances)


@dataclasses.dataclass(frozen=True)
class DumpyParams:
    """Full parameter set (paper §7 defaults, scaled by callers)."""

    sax: SaxParams = SaxParams()
    split: SplitParams = SplitParams()
    r: float = 1.0            # small-node threshold (× th) for packing
    rho: float = 0.5          # demotion-bit cap (× lambda)
    fuzzy_f: float = 0.0      # fuzzy boundary ratio (0 = plain Dumpy)
    max_replica: int = 3      # per-series duplication cap (paper §7)
    seed: int = 0

    @property
    def th(self) -> int:
        return self.split.th


class TreeNode:
    """One index node.  Leaves carry member series; internal nodes carry the
    chosen-segment list and an sid → child routing table (paper §5.1)."""

    __slots__ = ("sym", "card", "size", "depth", "csl", "children", "routing",
                 "series_ids", "leaf_id", "n_leaves", "is_pack", "pack_mask",
                 "pack_value")

    def __init__(self, sym: np.ndarray, card: np.ndarray, depth: int):
        self.sym = sym                     # [w] int64 prefix values
        self.card = card                   # [w] int64 cardinalities (bits)
        self.size = 0
        self.depth = depth
        self.csl: tuple[int, ...] | None = None
        self.children: dict[int, "TreeNode"] = {}
        self.routing: dict[int, "TreeNode"] = {}
        self.series_ids: np.ndarray | None = None
        self.leaf_id = -1
        self.n_leaves = 0
        self.is_pack = False
        self.pack_mask = 0
        self.pack_value = 0

    @property
    def is_leaf(self) -> bool:
        return self.csl is None

    def route_sid(self, sax_q: np.ndarray, b: int) -> int:
        """sid of a query under this node's split (promoteiSAX, Alg. 2)."""
        sid = 0
        for seg in self.csl:
            bit = (int(sax_q[seg]) >> (b - 1 - int(self.card[seg]))) & 1
            sid = (sid << 1) | bit
        return sid


@dataclasses.dataclass
class BuildStats:
    n_nodes: int = 0
    n_leaves: int = 0
    height: int = 0
    n_series: int = 0
    n_duplicates: int = 0
    fill_factor: float = 0.0
    plans_evaluated: int = 0


# ---------------------------------------------------------------------------
# Staged split pipeline — the recursion body of Algorithm 1 decomposed into
# pure stages shared by the host and device backends.
# ---------------------------------------------------------------------------

def plan_node_rows(sax_node: np.ndarray, card: np.ndarray, avail: list[int],
                   c_n: int, split: SplitParams, b: int) -> tuple[int, ...]:
    """Stage 3, reference evaluator: Alg. 2 plan from the node's raw rows
    (per-row histogram + row-wise segment variances + memoized DFS)."""
    bits = next_bits_np(sax_node[:, avail], card[avail], b)
    codes = pack_bits_np(bits)
    hist = np.bincount(codes, minlength=1 << len(avail)).astype(np.int64)
    seg_vars = segment_variances(sax_node[:, avail], b)
    return choose_split_plan(hist, seg_vars, avail, c_n, split)


def plan_node_grouped(words: np.ndarray, counts: np.ndarray, card: np.ndarray,
                      avail: list[int], c_n: int, split: SplitParams,
                      b: int) -> tuple[tuple[int, ...], int]:
    """Stage 3, optimized evaluator: the same objective from the node's
    (distinct SAX word, multiplicity) pairs.  Returns ``(csl, n_evals)``."""
    cols = words[:, avail]
    codes = pack_bits_np(next_bits_np(cols, card[avail], b))
    seg_vars = weighted_segment_variances(cols, counts, b)
    return plan_split(codes, counts, seg_vars, avail, c_n, split)


def partition_by_sid(sids: np.ndarray) -> dict[int, np.ndarray]:
    """Stage 2 helper: stable group-by → ``{sid: local indices}``, keys
    ascending, each group in original order."""
    groups: dict[int, np.ndarray] = {}
    order = np.argsort(sids, kind="stable")
    sorted_sids = sids[order]
    uniq, starts = np.unique(sorted_sids, return_index=True)
    bounds = np.append(starts, len(sorted_sids))
    for k, sid in enumerate(uniq):
        groups[int(sid)] = order[bounds[k]:bounds[k + 1]]
    return groups


def child_isax(sym: np.ndarray, card: np.ndarray, csl: tuple[int, ...],
               sid: int) -> tuple[np.ndarray, np.ndarray]:
    """Refine a parent iSAX word with one sid's split bits."""
    lam = len(csl)
    sym = sym.copy()
    card = card.copy()
    for pos, seg in enumerate(csl):
        bit = (sid >> (lam - 1 - pos)) & 1
        sym[seg] = (sym[seg] << 1) | bit
        card[seg] += 1
    return sym, card


def children_isax(sym: np.ndarray, card: np.ndarray, csl: tuple[int, ...],
                  sids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized :func:`child_isax` for a batch of sids → ``[K, w]`` each."""
    lam = len(csl)
    sids = np.asarray(sids, np.int64)
    K = len(sids)
    syms = np.tile(sym, (K, 1))
    cards = np.tile(card, (K, 1))
    cl = list(csl)
    bits = (sids[:, None] >> (lam - 1 - np.arange(lam))[None, :]) & 1
    syms[:, cl] = (sym[cl][None, :] << 1) | bits
    cards[:, cl] = card[cl][None, :] + 1
    return syms, cards


def pack_siblings(node: TreeNode, params: DumpyParams,
                  pending: frozenset | set = frozenset()
                  ) -> list[tuple[TreeNode, list[int], list[TreeNode]]]:
    """Stage 4 (Algorithm 3) on one parent's small leaf children; builds the
    routing table and rewires ``children`` (packed sids re-inserted at the
    end, the order ``flatten_routing`` serializes).

    ``pending`` — ``id()``s of children queued for further splitting: BFS
    drivers call this before those children are split, so they are excluded
    here exactly as the completed internal nodes were in the old post-order
    recursion.  Returns ``[(pack_node, member_sids, member_children)]``; the
    caller merges each pack's member payload (series ids on the host, word
    groups on the device) into the pack node.
    """
    p = params
    lam = len(node.csl)
    small_sids, small_sizes = [], []
    node.routing = {}
    for sid, child in node.children.items():
        if (id(child) not in pending and child.is_leaf
                and child.size < p.r * p.th):
            small_sids.append(sid)
            small_sizes.append(child.size)
        else:
            node.routing[sid] = child
    if len(small_sids) > 1:
        packs = pack_leaves(small_sids, small_sizes, lam, th=p.th,
                            r=p.r, rho=p.rho, seed=p.seed)
    elif small_sids:
        packs = [Pack(value=small_sids[0], mask=0, size=small_sizes[0],
                      members=[0])]
    else:
        packs = []
    out = []
    for pk in packs:
        member_sids = [small_sids[i] for i in pk.members]
        member_children = [node.children[s] for s in member_sids]
        sym, card = pack_isax(node.sym, node.card, node.csl, pk, p.sax.b)
        pnode = TreeNode(sym.astype(np.int64), card.astype(np.int64),
                         node.depth + 1)
        pnode.size = int(pk.size)
        pnode.is_pack = True
        pnode.pack_mask, pnode.pack_value = pk.mask, pk.value
        for s in member_sids:
            node.routing[s] = pnode
            del node.children[s]
            node.children[s] = pnode   # children view follows the pack
        out.append((pnode, member_sids, member_children))
    return out


def finalize_stats(root: TreeNode, stats: BuildStats, th: int) -> None:
    """Count nodes / leaves / height / fill factor over the finished tree."""

    def rec(node: TreeNode) -> int:
        stats.n_nodes += 1
        stats.height = max(stats.height, node.depth)
        if node.is_leaf:
            stats.n_leaves += 1
            node.n_leaves = 1
            return 1
        total = 0
        seen: set[int] = set()
        for child in node.children.values():
            if id(child) in seen:
                continue
            seen.add(id(child))
            total += rec(child)
        node.n_leaves = total
        return total

    rec(root)
    leaves = collect_leaves(root)
    if leaves:
        stats.fill_factor = float(np.mean([l.size for l in leaves])) / th


class DumpyBuilder:
    """Host backend for Algorithm 1: a breadth-first driver over the staged
    recursion body.  ``build`` accepts either raw series (encodes them) or a
    precomputed (paa, sax) pair from the device encoder."""

    def __init__(self, params: DumpyParams):
        self.p = params

    # -- Stage 1 -------------------------------------------------------------
    def encode(self, db: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        self.p.sax.validate_series_length(db.shape[-1])
        return sax_encode_np(db, self.p.sax)

    # -- Stages 2-4 ----------------------------------------------------------
    def build_tree(self, paa: np.ndarray, sax: np.ndarray) -> tuple[TreeNode, BuildStats]:
        p, w = self.p, self.p.sax.w
        n = sax.shape[0]
        stats = BuildStats(n_series=n)
        root = TreeNode(np.zeros(w, np.int64), np.zeros(w, np.int64), depth=0)
        root.size = n
        ids = np.arange(n, dtype=np.int64)
        self._rep_budget = np.full(n, p.max_replica, np.int32)
        if n <= p.th:
            root.series_ids = ids
        else:
            self._drive(root, ids, paa, sax, stats, is_root=True)
        finalize_stats(root, stats, p.th)
        return root, stats

    def build(self, db: np.ndarray) -> tuple[TreeNode, BuildStats, np.ndarray, np.ndarray]:
        paa, sax = self.encode(np.asarray(db, dtype=np.float32))
        root, stats = self.build_tree(paa, sax)
        return root, stats, paa, sax

    def split_subtree(self, node: TreeNode, ids: np.ndarray, paa: np.ndarray,
                      sax: np.ndarray, stats: BuildStats) -> None:
        """(Re-)split one subtree whose members are ``ids`` (global series
        ids), with a fuzzy replica budget scoped to those members.  Used by
        ``DumpyIndex._resplit`` on leaf overflow: work is proportional to the
        subtree, not the collection."""
        ids = np.asarray(ids, np.int64)
        local = np.arange(len(ids), dtype=np.int64)
        self._rep_budget = np.full(len(ids), self.p.max_replica, np.int32)
        self._drive(node, local, paa[ids], sax[ids], stats)
        for leaf in collect_leaves(node):
            if leaf.series_ids is not None:
                leaf.series_ids = ids[leaf.series_ids]

    # -------------------------------------------------------------------- --
    def _drive(self, node: TreeNode, ids: np.ndarray, paa: np.ndarray,
               sax: np.ndarray, stats: BuildStats, is_root: bool = False) -> None:
        """Breadth-first loop over the staged recursion body."""
        frontier = [(node, ids, is_root)]
        while frontier:
            nxt = []
            for nd, nids, rt in frontier:
                nxt.extend(self._split_node(nd, nids, paa, sax, stats, rt))
            frontier = nxt

    def _split_node(self, node: TreeNode, ids: np.ndarray, paa: np.ndarray,
                    sax: np.ndarray, stats: BuildStats, is_root: bool = False
                    ) -> list[tuple[TreeNode, np.ndarray, bool]]:
        """One expansion: plan → partition → children → pack.  Returns the
        children still needing a split (the next BFS frontier)."""
        p, w, b = self.p, self.p.sax.w, self.p.sax.b
        avail = [j for j in range(w) if node.card[j] < b]
        if not avail:                      # cannot refine further → forced leaf
            node.series_ids = ids
            return []
        sax_node = sax[ids]

        if is_root:
            csl = tuple(range(w)) if len(avail) == w else tuple(avail)  # Alg.2 l.1-2
        else:
            csl = plan_node_rows(sax_node, node.card, avail, len(ids),
                                 p.split, b)
        node.csl = csl

        bits = next_bits_np(sax_node[:, list(csl)], node.card[list(csl)], b)
        sids = pack_bits_np(bits)
        groups = partition_by_sid(sids)

        if p.fuzzy_f > 0.0:
            dups = fuzzy_mod.fuzzy_duplicates(
                paa[ids], sids, node.sym, node.card, csl, b, p.fuzzy_f,
                set(groups), self._rep_budget, ids)
            for tgt, local_idx in dups:
                groups[tgt] = np.concatenate([groups[tgt], local_idx])
                stats.n_duplicates += len(local_idx)

        pending: list[tuple[TreeNode, np.ndarray, bool]] = []
        pending_ids: set[int] = set()
        for sid, local in groups.items():
            child_ids = ids[local]
            sym, card = child_isax(node.sym, node.card, csl, sid)
            child = TreeNode(sym, card, node.depth + 1)
            child.size = len(child_ids)
            node.children[sid] = child
            if len(child_ids) > p.th and bool((card < b).any()):
                pending.append((child, child_ids, False))
                pending_ids.add(id(child))
            else:
                child.series_ids = child_ids

        for pnode, _, member_children in pack_siblings(node, p, pending_ids):
            pnode.series_ids = np.concatenate(
                [c.series_ids for c in member_children])
        return pending


def collect_leaves(root: TreeNode) -> list[TreeNode]:
    """All distinct leaves in DFS order (packs appear once)."""
    out: list[TreeNode] = []
    seen: set[int] = set()

    def rec(n: TreeNode) -> None:
        if id(n) in seen:
            return
        seen.add(id(n))
        if n.is_leaf:
            out.append(n)
            return
        for sid in sorted(n.children):
            rec(n.children[sid])

    rec(root)
    return out
