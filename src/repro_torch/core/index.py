"""DumpyIndex — the queryable artifact (port of ``repro.core.index``).

Combines the host routing tree (approximate-search descent, paper §5.5) with
flat structure-of-arrays state:

* ``leaf_sym / leaf_card``   — iSAX words of every leaf pack  ``[L, w]``
* ``leaf_lo / leaf_hi``      — precomputed region bounds       ``[L, w] f32``
* ``leaf_offsets``           — CSR offsets into the ordered collection
* ``order``                  — permutation: ordered position → original id
* ``db_ordered``             — the collection in leaf-contiguous layout
* ``paa_db / sax_db``        — summaries (kept for updates / fuzzy / stats)
* ``alive``                  — tombstone bit-vector for deletions (§5.6)

The host build, the flattening and the updates are numpy copies of the
reference, so the same data and parameters give the same tree and layout.
Crash-safe persistence (``save``/``load``, the write-ahead log) and the
device build backend arrive with later slices of the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..robustness.failpoints import failpoint, with_retries
from .build import BuildStats, DumpyBuilder, DumpyParams, TreeNode, collect_leaves
from .lb import node_bounds_np
from .sax import sax_encode_np


@dataclasses.dataclass
class FlatLeaves:
    leaf_sym: np.ndarray       # [L, w] int16 prefix values
    leaf_card: np.ndarray      # [L, w] uint8
    leaf_lo: np.ndarray        # [L, w] float32 (clamped)
    leaf_hi: np.ndarray        # [L, w] float32
    leaf_offsets: np.ndarray   # [L+1] int64
    order: np.ndarray          # [total] int64 original ids (with duplicates)

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_offsets) - 1


@dataclasses.dataclass
class FlatRouting:
    """Array form of the host routing tree.

    Internal nodes are numbered 0..M-1 (root = 0); their sid → child tables
    are concatenated into one edge list grouped by parent, in the host
    dict's insertion order.  The sibling tables carry each edge's and
    internal node's contiguous leaf-id span, each leaf's parent, and each
    internal node's distinct children begin-sorted (extended search,
    paper Alg. 4).
    """
    node_csl: np.ndarray      # [M, lam_max] int32 chosen segments, -1 padded
    node_shift: np.ndarray    # [M, lam_max] int32 next-bit shift (b-1-card)
    node_lam: np.ndarray      # [M] int32 split arity in bits
    edge_parent: np.ndarray   # [E] int32 internal node owning the entry
    edge_sid: np.ndarray      # [E] int64 routing key under the parent's split
    edge_leaf: np.ndarray     # [E] int32 leaf_id, or -1 for internal children
    edge_child: np.ndarray    # [E] int32 internal node id, or -1 for leaves
    edge_lo: np.ndarray       # [E, w] float32 child region bounds (clamped)
    edge_hi: np.ndarray       # [E, w] float32
    edge_nl: np.ndarray       # [E] int32 #leaves under the edge target
    edge_begin: np.ndarray    # [E] int32 contiguous leaf span of the target
    edge_end: np.ndarray      # [E] int32
    node_begin: np.ndarray    # [M] int32 per-internal-node subtree leaf span
    node_end: np.ndarray      # [M] int32
    leaf_parent: np.ndarray   # [L] int32 parent internal node (-1: root leaf)
    grp_off: np.ndarray       # [M+1] int32 distinct-children group offsets
    grp_begin: np.ndarray     # [G] int32 member spans, begin-sorted per group
    grp_end: np.ndarray       # [G] int32
    grp_lo: np.ndarray        # [G, w] float32 member region bounds (clamped)
    grp_hi: np.ndarray        # [G, w] float32
    depth: int                # max #descent steps to reach any leaf

    @property
    def gmax(self) -> int:
        """Max distinct children of any internal node (schedule gather width)."""
        if len(self.grp_off) <= 1:
            return 1
        return max(int(np.diff(self.grp_off).max()), 1)

    def stop_span_cap(self, nbr: int) -> int:
        """Widest subtree leaf span among internal nodes where the
        extended-search descent can stop under budget ``nbr`` (a node stops
        the descent iff one of its edges targets a leaf or a subtree of at
        most ``nbr`` leaves).  The device sibling schedule sorts only a
        window this wide instead of all ``L`` leaves; at worst (a stoppable
        node near the root) it is ``L`` and nothing is lost."""
        if len(self.edge_parent) == 0:
            return 1
        stop = (self.edge_leaf >= 0) | (self.edge_nl <= int(nbr))
        if not stop.any():
            return 1
        parents = self.edge_parent[stop]
        width = self.node_end[parents] - self.node_begin[parents]
        return max(int(width.max()), 1)


def _subtree_spans(root: TreeNode) -> dict[int, tuple[int, int]]:
    """``id(node) → (leaf_begin, leaf_end)`` contiguous leaf-id span of every
    node's subtree (leaf ids come from :func:`flatten_tree`'s sorted-sid
    DFS, so every span is contiguous)."""
    memo: dict[int, tuple[int, int]] = {}

    def rec(node: TreeNode) -> tuple[int, int]:
        key = id(node)
        if key in memo:
            return memo[key]
        if node.is_leaf:
            sp = (int(node.leaf_id), int(node.leaf_id) + 1)
        else:
            b_, e_ = None, None
            seen: set[int] = set()
            for child in node.children.values():
                if id(child) in seen:
                    continue
                seen.add(id(child))
                cb, ce = rec(child)
                b_ = cb if b_ is None else min(b_, cb)
                e_ = ce if e_ is None else max(e_, ce)
            sp = (b_ or 0, e_ or 0)
        memo[key] = sp
        return sp

    rec(root)
    return memo


def flatten_routing(root: TreeNode, b: int) -> FlatRouting:
    """Assign internal-node ids breadth-first and emit the edge, span and
    sibling-group tables.  Requires leaf ids already assigned by
    :func:`flatten_tree`."""
    internal: list[TreeNode] = []
    ids: dict[int, int] = {}
    queue = [root] if not root.is_leaf else []
    while queue:
        node = queue.pop(0)
        if id(node) in ids:
            continue
        ids[id(node)] = len(internal)
        internal.append(node)
        seen: set[int] = set()
        for child in node.children.values():
            if not child.is_leaf and id(child) not in seen:
                seen.add(id(child))
                queue.append(child)

    spans = _subtree_spans(root)
    L = max(spans[id(root)][1], 1)
    M = len(internal)
    w = root.sym.shape[0]
    lam_max = max((len(n.csl) for n in internal), default=1)
    node_csl = np.full((M, lam_max), -1, np.int32)
    node_shift = np.zeros((M, lam_max), np.int32)
    node_lam = np.zeros(M, np.int32)
    node_begin = np.zeros(M, np.int32)
    node_end = np.zeros(M, np.int32)
    leaf_parent = np.full(L, -1, np.int32)
    ep, es, el, ec, lo_rows, hi_rows = [], [], [], [], [], []
    enl, ebg, eed = [], [], []
    grp_off = np.zeros(M + 1, np.int32)
    gb, ge, glo, ghi = [], [], [], []
    depth = 0
    for m, node in enumerate(internal):
        node_lam[m] = len(node.csl)
        node_begin[m], node_end[m] = spans[id(node)]
        for pos, seg in enumerate(node.csl):
            node_csl[m, pos] = seg
            node_shift[m, pos] = b - 1 - int(node.card[seg])
        members: list[TreeNode] = []
        seen_c: set[int] = set()
        for sid, child in node.children.items():
            tgt = node.routing.get(sid) or child
            ep.append(m)
            es.append(int(sid))
            el.append(int(tgt.leaf_id) if tgt.is_leaf else -1)
            ec.append(-1 if tgt.is_leaf else ids[id(tgt)])
            sb, se_ = spans[id(tgt)]
            enl.append(se_ - sb)
            ebg.append(sb)
            eed.append(se_)
            lo, hi = node_bounds_np(tgt.sym[None, :], tgt.card[None, :], b)
            lo_rows.append(lo[0])
            hi_rows.append(hi[0])
            if id(tgt) not in seen_c:
                seen_c.add(id(tgt))
                members.append(tgt)
                if tgt.is_leaf:
                    leaf_parent[tgt.leaf_id] = m
        # sibling group: distinct children, begin-sorted (spans are disjoint)
        members.sort(key=lambda c: spans[id(c)][0])
        grp_off[m + 1] = grp_off[m] + len(members)
        for c in members:
            cb, ce = spans[id(c)]
            gb.append(cb)
            ge.append(ce)
            clo, chi = node_bounds_np(c.sym[None, :], c.card[None, :], b)
            glo.append(clo[0])
            ghi.append(chi[0])
        depth = max(depth, node.depth + 1)
    E = len(ep)
    G = len(gb)
    return FlatRouting(
        node_csl, node_shift, node_lam,
        np.asarray(ep, np.int32), np.asarray(es, np.int64),
        np.asarray(el, np.int32), np.asarray(ec, np.int32),
        (np.stack(lo_rows) if E else np.zeros((0, w), np.float32)),
        (np.stack(hi_rows) if E else np.zeros((0, w), np.float32)),
        np.asarray(enl, np.int32), np.asarray(ebg, np.int32),
        np.asarray(eed, np.int32),
        node_begin, node_end, leaf_parent, grp_off,
        np.asarray(gb, np.int32), np.asarray(ge, np.int32),
        (np.stack(glo) if G else np.zeros((0, w), np.float32)),
        (np.stack(ghi) if G else np.zeros((0, w), np.float32)),
        max(depth, 1))


def flatten_tree(root: TreeNode, b: int) -> FlatLeaves:
    leaves = collect_leaves(root)
    L = len(leaves)
    w = root.sym.shape[0]
    sym = np.zeros((L, w), np.int16)
    card = np.zeros((L, w), np.uint8)
    sizes = np.zeros(L, np.int64)
    chunks = []
    for i, leaf in enumerate(leaves):
        leaf.leaf_id = i
        sym[i] = leaf.sym
        card[i] = leaf.card
        ids = leaf.series_ids if leaf.series_ids is not None else np.empty(0, np.int64)
        sizes[i] = len(ids)
        chunks.append(ids)
    offsets = np.zeros(L + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    order = (np.concatenate(chunks) if chunks else np.empty(0, np.int64))
    lo, hi = node_bounds_np(sym, card, b)
    return FlatLeaves(sym, card, lo, hi, offsets, order)


class DumpyIndex:
    """Built index over a collection ``db [N, n] float32``."""

    def __init__(self, params: DumpyParams, root: TreeNode, flat: FlatLeaves,
                 db: np.ndarray, paa: np.ndarray, sax: np.ndarray,
                 stats: BuildStats):
        self.params = params
        self.root = root
        self.db = db
        self.paa = paa
        self.sax = sax
        self.stats = stats
        self.alive = np.ones(db.shape[0], bool)
        self._routing_flat: FlatRouting | None = None
        # Materialized layout state — rebuilt lazily after updates (§5.6):
        # ``_dirty`` marks the tree as changed since ``_flat`` was derived.
        self._flat = flat
        self._dirty = False
        self._db_ordered: np.ndarray | None = None
        self._n_layout_builds = 0              # observability (tests)
        self._n_device_builds = 0              # cache-miss DeviceIndex builds
        # (chunk, n_shards, device) → (DeviceIndex, alive snapshot);
        # invalidated by updates (insert rebuilds the layout; delete
        # refreshes the alive mask per entry)
        self._device_cache: dict = {}

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, db: np.ndarray, params: DumpyParams | None = None,
              backend: str = "host") -> "DumpyIndex":
        """Build the index with the host backend (reference Alg. 1
        recursion).  The device backend arrives with a later slice."""
        params = params or DumpyParams()
        db = np.ascontiguousarray(db, dtype=np.float32)
        if backend == "device":
            raise NotImplementedError(
                "backend='device' is not ported yet (device build slice)")
        if backend != "host":
            raise ValueError(f"unknown build backend: {backend!r}")
        builder = DumpyBuilder(params)
        root, stats, paa, sax = builder.build(db)
        flat = flatten_tree(root, params.sax.b)
        return cls(params, root, flat, db, paa, sax, stats)

    # -- lazy layout ---------------------------------------------------------
    @property
    def flat(self) -> FlatLeaves:
        """Leaf-contiguous layout; re-derived from the tree on first access
        after an update instead of once per ``insert``."""
        if self._dirty:
            self._rebuild_layout()
        return self._flat

    @property
    def db_ordered(self) -> np.ndarray:
        """The collection permuted into leaf-contiguous layout (lazy)."""
        if self._dirty:
            self._rebuild_layout()
        if self._db_ordered is None:
            self._db_ordered = self.db[self._flat.order]
        return self._db_ordered

    def _invalidate_layout(self) -> None:
        self._dirty = True
        self._db_ordered = None
        self._routing_flat = None
        self._device_cache.clear()    # layout changed: device state is stale

    def _rebuild_layout(self) -> None:
        self._flat = flatten_tree(self.root, self.params.sax.b)
        self._dirty = False
        self._n_layout_builds += 1

    @property
    def n(self) -> int:
        return self.db.shape[1]

    @property
    def w(self) -> int:
        return self.params.sax.w

    # -- updates (§5.6) -------------------------------------------------------
    def delete(self, series_id: int) -> None:
        self.alive[series_id] = False

    def insert(self, series: np.ndarray) -> int:
        """Append one series; returns the new series id."""
        return int(self.insert_many(np.asarray(series,
                                               np.float32).reshape(1, -1))[0])

    def insert_many(self, batch: np.ndarray) -> np.ndarray:
        """Append a batch of series in one pass: one encode, one set of array
        concatenations, one routing loop, each overflowing leaf resplit once
        after all routing, and a single (lazy) layout invalidation.  Returns
        the new series ids."""
        batch = np.ascontiguousarray(batch, np.float32)
        if batch.ndim != 2:
            batch = batch.reshape(1, -1)
        if batch.shape[1] != self.n:
            raise ValueError(
                f"insert_many: series length {batch.shape[1]} != index "
                f"length {self.n}")
        m = batch.shape[0]
        n0 = self.db.shape[0]
        new_ids = np.arange(n0, n0 + m, dtype=np.int64)
        paa_b, sax_b = sax_encode_np(batch, self.params.sax)
        self.db = np.concatenate([self.db, batch])
        self.paa = np.concatenate([self.paa, paa_b])
        self.sax = np.concatenate([self.sax, sax_b])
        self.alive = np.append(self.alive, np.ones(m, bool))

        overflowed: dict[int, TreeNode] = {}
        for i in range(m):
            sax_s = sax_b[i]
            node = self.root
            while not node.is_leaf:
                sid = node.route_sid(sax_s, self.params.sax.b)
                child = node.routing.get(sid) or node.children.get(sid)
                if child is None:        # new region → fresh leaf under node
                    child = self._new_leaf_under(node, sid, sax_s)
                node = child
            node.series_ids = np.append(node.series_ids, new_ids[i])
            node.size += 1
            if node.size > self.params.th:
                overflowed[id(node)] = node
        for node in overflowed.values():
            # overflowing leaf — or full pack (§5.6: the pack is dissolved and
            # reorganized; its demoted iSAX word is a valid coarser rectangle)
            node.is_pack = False
            self._resplit(node)
        self._invalidate_layout()
        return new_ids

    def _new_leaf_under(self, node: TreeNode, sid: int, sax_q: np.ndarray) -> TreeNode:
        lam = len(node.csl)
        sym, card = node.sym.copy(), node.card.copy()
        for pos, seg in enumerate(node.csl):
            bit = (sid >> (lam - 1 - pos)) & 1
            sym[seg] = (sym[seg] << 1) | bit
            card[seg] += 1
        leaf = TreeNode(sym, card, node.depth + 1)
        leaf.series_ids = np.empty(0, np.int64)
        node.children[sid] = leaf
        node.routing[sid] = leaf
        return leaf

    def _resplit(self, leaf: TreeNode) -> None:
        """Re-run the adaptive split on an overflowing leaf; the fuzzy
        replica budget is scoped to the leaf's members."""
        builder = DumpyBuilder(self.params)
        stats = BuildStats()
        ids = leaf.series_ids
        leaf.series_ids = None
        builder.split_subtree(leaf, ids, self.paa, self.sax, stats)

    @property
    def routing_flat(self) -> FlatRouting:
        """Flat routing tables (built lazily; leaf ids must come from the
        current ``flat`` layout, hence after flatten_tree)."""
        if self._routing_flat is None:
            _ = self.flat                 # ensure leaf ids are current
            self._routing_flat = flatten_routing(self.root, self.params.sax.b)
        return self._routing_flat

    def device_index(self, chunk: int = 2048, n_shards: int = 1,
                     device: str | torch.device = "cuda"):
        """The cached :class:`~repro_torch.core.device_index.DeviceIndex` for
        this layout on ``device`` (built lazily per (chunk, n_shards,
        device); ``insert`` invalidates wholesale, tombstone drift is
        detected against the ``alive`` snapshot and refreshed without
        rebuilding the layout).  ``device`` defaults to CUDA and raises
        where CUDA is absent unless ``"cpu"`` is asked for."""
        from .device_index import DeviceIndex, resolve_device
        device = resolve_device(device)
        key = (int(chunk), int(n_shards), str(device))
        cached = self._device_cache.get(key)
        if cached is None:
            def _build():
                failpoint("device.put")
                return DeviceIndex.from_index(self, chunk=chunk,
                                              n_shards=n_shards, device=device)

            # transient upload failures (device OOM races, injected faults)
            # are retried with backoff before giving up
            dev = with_retries(_build, site="device.put")
            self._n_device_builds += 1
            self._device_cache[key] = (dev, self.alive.copy())
            return dev
        dev, alive_snap = cached
        if not np.array_equal(alive_snap, self.alive):
            dev = dev.with_alive(self.alive)
            self._device_cache[key] = (dev, self.alive.copy())
        return dev
