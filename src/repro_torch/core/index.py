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
reference, so the same data and parameters give the same tree and layout;
``backend="device"`` builds through ``core/build_device.py``.

Save/load is npz+json (no pickle), including the tree, and is crash-safe:
each ``save()`` writes a fresh *generation* directory plus a checksummed
``manifest.json``, and commits by atomically replacing a ``CURRENT``
pointer file; ``load()`` verifies checksums and falls back to the previous
intact generation, then replays the generation's write-ahead log so
``insert_many`` batches survive a crash between saves.  The on-disk format
is the reference's (the same files, array names, dtypes and JSON, byte for
byte but for the zip entries' times): a store written by either package
loads in the other.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import re
import shutil

import numpy as np
import torch

from ..robustness.failpoints import failpoint, with_retries
from ..robustness.wal import WriteAheadLog
from .build import BuildStats, DumpyBuilder, DumpyParams, TreeNode, collect_leaves
from .lb import node_bounds_np
from .sax import sax_encode_np

#: on-disk format version (manifest.json); bump on layout changes
FORMAT_VERSION = 2
#: generations kept after a successful commit (current + fallback)
KEEP_GENERATIONS = 2

_CURRENT = "CURRENT"
_GEN_RE = re.compile(r"^gen-(\d{6})$")


class IndexCorruptionError(RuntimeError):
    """A persisted index failed verification (checksum mismatch, missing
    file, or inconsistent array shapes/dtypes)."""


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

    def leaf_slice(self, leaf_id: int) -> np.ndarray:
        return self.order[self.leaf_offsets[leaf_id]:self.leaf_offsets[leaf_id + 1]]


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
    def n_nodes(self) -> int:
        return len(self.node_lam)

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
        self._db_ordered_dev: torch.Tensor | None = None   # device build's rows
        self._n_layout_builds = 0              # observability (tests)
        self._n_device_builds = 0              # cache-miss DeviceIndex builds
        # (chunk, n_shards, device, mesh) → (DeviceIndex, alive snapshot);
        # invalidated by updates (insert rebuilds the layout; delete
        # refreshes the alive mask per entry)
        self._device_cache: dict = {}
        # durability: set by save()/load() — while attached, insert_many
        # appends each batch to the store's write-ahead log before mutating
        self._store_path: str | None = None
        self._wal: WriteAheadLog | None = None

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, db: np.ndarray, params: DumpyParams | None = None,
              backend: str = "host",
              device: str | torch.device = "cuda") -> "DumpyIndex":
        """Build the index with either the host backend (reference Alg. 1
        recursion) or the device backend (bottom-up grouped build on
        ``device``, ``core/build_device.py``; CUDA unless the caller asks
        for the CPU).  Both give the same layout on data where no two split
        plans score exactly equal."""
        params = params or DumpyParams()
        db = np.ascontiguousarray(db, dtype=np.float32)
        if backend == "device":
            from .build_device import device_build
            return cls.from_device_build(db, params,
                                         device_build(db, params,
                                                      device=device))
        if backend != "host":
            raise ValueError(f"unknown build backend: {backend!r}")
        builder = DumpyBuilder(params)
        root, stats, paa, sax = builder.build(db)
        flat = flatten_tree(root, params.sax.b)
        return cls(params, root, flat, db, paa, sax, stats)

    @classmethod
    def from_device_build(cls, db: np.ndarray, params: DumpyParams,
                          res) -> "DumpyIndex":
        """The index of a :func:`~repro_torch.core.build_device.device_build`
        result over ``db``; it keeps the ordered rows on the device for
        :meth:`device_index`."""
        idx = cls(params, res.root, res.flat, db, res.paa, res.sax,
                  res.stats)
        idx._db_ordered_dev = res.db_ordered_dev
        return idx

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
        self._db_ordered_dev = None
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

    def insert_many(self, batch: np.ndarray,
                    log_wal: bool = True) -> np.ndarray:
        """Append a batch of series in one pass: one encode, one set of array
        concatenations, one routing loop, each overflowing leaf resplit once
        after all routing, and a single (lazy) layout invalidation.  Returns
        the new series ids.

        When the index is attached to a store (after ``save``/``load``) the
        batch is first appended to the generation's write-ahead log, so a
        crash before the next ``save()`` loses nothing: ``load`` replays the
        log on top of the loaded generation.  ``log_wal=False`` is the replay
        path itself (and callers that explicitly opt out of durability)."""
        batch = np.ascontiguousarray(batch, np.float32)
        if batch.ndim != 2:
            batch = batch.reshape(1, -1)
        if batch.shape[1] != self.n:
            raise ValueError(
                f"insert_many: series length {batch.shape[1]} != index "
                f"length {self.n}")
        if log_wal and self._wal is not None:
            self._wal.append(batch)   # durable before any in-memory mutation
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
                     device: str | torch.device = "cuda", mesh=None):
        """The cached :class:`~repro_torch.core.device_index.DeviceIndex` for
        this layout on ``device`` (built lazily per (chunk, n_shards,
        device, mesh); ``insert`` invalidates wholesale, tombstone drift is
        detected against the ``alive`` snapshot and refreshed without
        rebuilding the layout).  ``device`` defaults to CUDA and raises
        where CUDA is absent unless ``"cpu"`` is asked for.

        With ``mesh`` (``repro_torch.distributed.sharding.Mesh``) the index
        has one shard per mesh entry, placed by ``DeviceIndex.shard``, and
        ``device`` is the mesh's first device; the mesh is part of the
        cache key, so the same shard count on another (or no) mesh never
        reuses a stale placement."""
        from .device_index import DeviceIndex, resolve_device
        if mesh is not None:
            if int(n_shards) not in (1, mesh.size):
                raise ValueError(f"n_shards={n_shards} on a mesh of "
                                 f"{mesh.size} devices")
            n_shards, device = mesh.size, mesh.devices[0]
        device = resolve_device(device)
        key = (int(chunk), int(n_shards), str(device), mesh)
        cached = self._device_cache.get(key)
        if cached is None:
            # device-built indexes keep db_ordered on the device: assemble
            # the DeviceIndex from those rows without a host round-trip
            # a mesh over several devices lays the shards out on the host
            # and sends each to its own device: the first card never holds
            # the whole collection
            build_on = (device if mesh is None or len(mesh.distinct) == 1
                        else torch.device("cpu"))

            def _build():
                failpoint("device.put")
                dev = DeviceIndex.from_index(
                    self, chunk=chunk, n_shards=n_shards, device=build_on,
                    db_device=self._db_ordered_dev)
                return dev.shard(mesh) if mesh is not None else dev

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

    # -- serialization ---------------------------------------------------------
    #
    # On-disk layout (the reference's, byte for byte):
    #
    #   path/
    #     CURRENT            -> "gen-000002\n"   (the commit pointer)
    #     gen-000001/        arrays.npz, meta.json, manifest.json
    #     gen-000002/        ...
    #     wal-000002.log     inserts since gen-000002 was committed
    #
    # A save writes a complete new generation under gen-NNNNNN.tmp, renames
    # it into place, and *commits* with a single os.replace of CURRENT — the
    # only mutation of shared state.  Every earlier step is invisible to
    # load(); every later step (pruning old generations) is cleanup.

    def save(self, path: str) -> None:
        """Write a new checksummed generation and atomically commit it.

        Idempotent and crash-safe: stale ``*.tmp`` droppings from an earlier
        crashed save are cleared on entry, nothing existing is touched until
        the final ``CURRENT`` replace, and a crash at any point leaves the
        previous generation (plus its write-ahead log) fully loadable."""
        os.makedirs(path, exist_ok=True)
        for name in os.listdir(path):       # stale tmp dirs from a crash
            if name.endswith(".tmp"):
                full = os.path.join(path, name)
                shutil.rmtree(full) if os.path.isdir(full) else os.remove(full)
        legacy_tmp = path.rstrip("/") + ".tmp"    # pre-v2 save() droppings
        if os.path.isdir(legacy_tmp):
            shutil.rmtree(legacy_tmp)
        failpoint("index.save.begin")

        gen_id = max(_generation_ids(path), default=0) + 1
        gen_name = f"gen-{gen_id:06d}"
        wal_name = f"wal-{gen_id:06d}.log"
        tmp = os.path.join(path, gen_name + ".tmp")
        os.makedirs(tmp)

        buf = io.BytesIO()
        arrays = dict(db=self.db, paa=self.paa, sax=self.sax,
                      alive=self.alive,
                      leaf_sym=self.flat.leaf_sym,
                      leaf_card=self.flat.leaf_card,
                      leaf_offsets=self.flat.leaf_offsets,
                      order=self.flat.order)
        np.savez(buf, **arrays)
        arrays_bytes = buf.getbuffer()        # no copy of the collection
        meta = {"params": _params_to_json(self.params),
                "stats": dataclasses.asdict(self.stats),
                "tree": _tree_to_json(self.root)}
        meta_bytes = json.dumps(meta).encode()
        manifest = {
            "format_version": FORMAT_VERSION,
            "generation": gen_name,
            "wal": wal_name,
            "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in arrays.items()},
            "files": {"arrays.npz": _sha256(arrays_bytes),
                      "meta.json": _sha256(meta_bytes)},
        }
        manifest_bytes = json.dumps(manifest, indent=1).encode()

        _write_durable(os.path.join(tmp, "arrays.npz"), arrays_bytes,
                       site="index.save.arrays")
        _write_durable(os.path.join(tmp, "meta.json"), meta_bytes,
                       site="index.save.meta")
        _write_durable(os.path.join(tmp, "manifest.json"), manifest_bytes,
                       site="index.save.manifest")

        failpoint("index.save.rename")
        os.replace(tmp, os.path.join(path, gen_name))
        _fsync_dir(path)

        # the commit: one atomic pointer flip
        failpoint("index.save.commit")
        _write_durable(os.path.join(path, _CURRENT + ".tmp"),
                       (gen_name + "\n").encode())
        os.replace(os.path.join(path, _CURRENT + ".tmp"),
                   os.path.join(path, _CURRENT))
        _fsync_dir(path)
        failpoint("index.save.post_commit")

        # committed: future inserts log to this generation's (fresh) WAL
        self._store_path = path
        self._wal = WriteAheadLog(os.path.join(path, wal_name))
        self._wal.reset()

        failpoint("index.save.prune")
        self._prune_generations(path, gen_id)

    @staticmethod
    def _prune_generations(path: str, current_id: int) -> None:
        """Drop generations (and their WALs) older than the fallback window.
        Pure cleanup — a crash here leaves extra, still-valid generations."""
        keep = {current_id - k for k in range(KEEP_GENERATIONS)}
        for gid in _generation_ids(path):
            if gid in keep:
                continue
            shutil.rmtree(os.path.join(path, f"gen-{gid:06d}"),
                          ignore_errors=True)
            wal = os.path.join(path, f"wal-{gid:06d}.log")
            if os.path.exists(wal):
                os.remove(wal)

    @classmethod
    def load(cls, path: str) -> "DumpyIndex":
        """Load the newest intact generation and replay its write-ahead log.

        The ``CURRENT`` pointer names the committed generation; if that
        generation fails verification (checksum mismatch, missing or
        inconsistent files) the remaining generations are tried newest-first,
        so a flipped bit degrades to the previous save instead of a crash
        deep inside ``flatten_tree``.  Raises :class:`IndexCorruptionError`
        when no generation verifies.  The loaded index is clean: layout
        current, no device state (``device_index()`` builds it anew)."""
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no index at {path!r}")
        gens = sorted(_generation_ids(path), reverse=True)
        if not gens and os.path.exists(os.path.join(path, "arrays.npz")):
            return cls._load_legacy(path)     # pre-generation flat layout
        if not gens:
            raise FileNotFoundError(f"no index generations under {path!r}")

        candidates: list[str] = []
        current = _read_current(path)
        if current is not None:
            candidates.append(current)
        candidates += [f"gen-{g:06d}" for g in gens
                       if f"gen-{g:06d}" not in candidates]
        errors: list[str] = []
        for gen_name in candidates:
            try:
                failpoint("index.load.verify")
                idx, manifest = cls._load_generation(
                    os.path.join(path, gen_name))
            except (IndexCorruptionError, OSError, ValueError, KeyError) as e:
                errors.append(f"{gen_name}: {type(e).__name__}: {e}")
                continue
            idx._attach_store(path, manifest.get("wal", f"{gen_name}.wal"))
            return idx
        raise IndexCorruptionError(
            f"no intact generation under {path!r}; tried: " + "; ".join(errors))

    @classmethod
    def _load_generation(cls, gen_dir: str) -> tuple["DumpyIndex", dict]:
        with open(os.path.join(gen_dir, "manifest.json"), "rb") as fh:
            manifest = json.load(fh)
        if manifest.get("format_version") != FORMAT_VERSION:
            raise IndexCorruptionError(
                f"{gen_dir}: format_version {manifest.get('format_version')!r}"
                f" != {FORMAT_VERSION}")
        blobs: dict[str, bytes] = {}
        for fname, want in manifest["files"].items():
            full = os.path.join(gen_dir, fname)
            if not os.path.exists(full):
                raise IndexCorruptionError(f"{gen_dir}: missing {fname}")
            with open(full, "rb") as fh:
                data = fh.read()
            got = _sha256(data)
            if got != want:
                raise IndexCorruptionError(
                    f"{gen_dir}/{fname}: sha256 mismatch "
                    f"(manifest {want[:12]}…, file {got[:12]}…)")
            blobs[fname] = data
        arrs = dict(np.load(io.BytesIO(blobs.pop("arrays.npz"))))
        for name, spec in manifest["arrays"].items():
            if name not in arrs:
                raise IndexCorruptionError(f"{gen_dir}: array {name!r} "
                                           f"missing from arrays.npz")
            a = arrs[name]
            if list(a.shape) != spec["shape"] or str(a.dtype) != spec["dtype"]:
                raise IndexCorruptionError(
                    f"{gen_dir}: array {name!r} is {a.shape}/{a.dtype}, "
                    f"manifest says {tuple(spec['shape'])}/{spec['dtype']}")
        meta = json.loads(blobs["meta.json"])
        return cls._from_loaded(arrs, meta, where=gen_dir), manifest

    @classmethod
    def _load_legacy(cls, path: str) -> "DumpyIndex":
        """Pre-v2 layout: arrays.npz + meta.json directly under ``path``
        (no manifest, no checksums — validation only)."""
        arrs = dict(np.load(os.path.join(path, "arrays.npz")))
        with open(os.path.join(path, "meta.json")) as fh:
            meta = json.load(fh)
        idx = cls._from_loaded(arrs, meta, where=path)
        idx._attach_store(path, "wal-legacy.log")
        return idx

    @classmethod
    def _from_loaded(cls, arrs: dict, meta: dict, where: str) -> "DumpyIndex":
        params = _params_from_json(meta["params"])
        root = _tree_from_json(meta["tree"])
        stats = BuildStats(**meta["stats"])
        _validate_arrays(arrs, params, where)
        flat = flatten_tree(root, params.sax.b)
        # the layout is re-derived from the tree; it must agree with what
        # was saved or the tree and arrays are from different states
        if not np.array_equal(flat.order, arrs["order"]) or \
                not np.array_equal(flat.leaf_offsets, arrs["leaf_offsets"]):
            raise IndexCorruptionError(
                f"{where}: routing tree disagrees with saved leaf layout")
        idx = cls(params, root, flat, arrs["db"], arrs["paa"], arrs["sax"],
                  stats)
        idx.alive = np.asarray(arrs["alive"], bool)
        # a freshly loaded index is clean: layout current, no pending
        # inserts, empty device cache (caches are per-process, not persisted)
        idx._dirty = False
        idx._device_cache.clear()
        return idx

    def _attach_store(self, path: str, wal_name: str) -> None:
        """Bind this index to its on-disk store and replay any write-ahead
        log the committed generation left behind (inserts that happened
        after the save)."""
        self._store_path = path
        self._wal = WriteAheadLog(os.path.join(path, wal_name))
        for batch in self._wal.replay():
            self.insert_many(batch, log_wal=False)


# -- persistence helpers -------------------------------------------------------

def _sha256(data) -> str:
    return hashlib.sha256(data).hexdigest()


def _write_durable(path: str, data, site: str | None = None) -> None:
    """Write + fsync a file; when ``site`` is given the write is a failpoint
    and transient faults are retried with backoff."""
    def _write():
        if site is not None:
            failpoint(site)
        with open(path, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
    if site is None:
        _write()
    else:
        with_retries(_write, site=site)


def _fsync_dir(path: str) -> None:
    """Persist directory-entry renames (no-op on platforms without O_DIRECTORY
    semantics)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _generation_ids(path: str) -> list[int]:
    out = []
    try:
        names = os.listdir(path)
    except FileNotFoundError:
        return out
    for name in names:
        m = _GEN_RE.match(name)
        if m and os.path.isdir(os.path.join(path, name)):
            out.append(int(m.group(1)))
    return out


def _read_current(path: str) -> str | None:
    try:
        with open(os.path.join(path, _CURRENT)) as fh:
            name = fh.read().strip()
    except OSError:
        return None
    return name if _GEN_RE.match(name) else None


def _validate_arrays(arrs: dict, params: DumpyParams, where: str) -> None:
    """Cross-consistency checks over the loaded arrays — precise
    :class:`IndexCorruptionError` instead of an opaque failure deep inside
    ``flatten_tree`` or the first search."""
    def bad(msg: str):
        raise IndexCorruptionError(f"{where}: {msg}")

    for name in ("db", "paa", "sax", "alive", "leaf_sym", "leaf_card",
                 "leaf_offsets", "order"):
        if name not in arrs:
            bad(f"array {name!r} missing")
    db, paa, sax = arrs["db"], arrs["paa"], arrs["sax"]
    alive, order = arrs["alive"], arrs["order"]
    offsets = arrs["leaf_offsets"]
    if db.ndim != 2 or db.dtype != np.float32:
        bad(f"db must be [N, n] float32, got {db.shape}/{db.dtype}")
    N, w = db.shape[0], params.sax.w
    if paa.shape != (N, w):
        bad(f"paa shape {paa.shape} != (N={N}, w={w})")
    if sax.shape != (N, w):
        bad(f"sax shape {sax.shape} != (N={N}, w={w})")
    if alive.shape != (N,) or alive.dtype != np.bool_:
        bad(f"alive must be [N] bool, got {alive.shape}/{alive.dtype}")
    L = arrs["leaf_sym"].shape[0]
    if arrs["leaf_sym"].shape != (L, w) or arrs["leaf_card"].shape != (L, w):
        bad(f"leaf tables {arrs['leaf_sym'].shape}/"
            f"{arrs['leaf_card'].shape} inconsistent with w={w}")
    if offsets.shape != (L + 1,) or (np.diff(offsets) < 0).any():
        bad(f"leaf_offsets must be [L+1] non-decreasing "
            f"(L={L}, got {offsets.shape})")
    if len(order) != (int(offsets[-1]) if len(offsets) else 0):
        bad(f"order has {len(order)} entries, leaf_offsets expects "
            f"{int(offsets[-1])}")
    if len(order) and (order.min() < 0 or order.max() >= N):
        bad(f"order references series id {int(order.max())} outside [0, {N})")


# -- json helpers (no pickle) --------------------------------------------------

def _params_to_json(p: DumpyParams) -> dict:
    return {"w": p.sax.w, "b": p.sax.b, "th": p.split.th,
            "alpha": p.split.alpha, "f_low": p.split.f_low,
            "f_high": p.split.f_high, "r": p.r, "rho": p.rho,
            "fuzzy_f": p.fuzzy_f, "max_replica": p.max_replica, "seed": p.seed}


def _params_from_json(d: dict) -> DumpyParams:
    from .sax import SaxParams
    from .split import SplitParams
    return DumpyParams(sax=SaxParams(w=d["w"], b=d["b"]),
                       split=SplitParams(th=d["th"], alpha=d["alpha"],
                                         f_low=d["f_low"], f_high=d["f_high"]),
                       r=d["r"], rho=d["rho"], fuzzy_f=d["fuzzy_f"],
                       max_replica=d["max_replica"], seed=d["seed"])


def _tree_to_json(node: TreeNode) -> dict:
    d = {"sym": node.sym.tolist(), "card": node.card.tolist(),
         "size": node.size, "depth": node.depth, "n_leaves": node.n_leaves,
         "is_pack": node.is_pack, "pack_mask": node.pack_mask,
         "pack_value": node.pack_value}
    if node.is_leaf:
        d["series_ids"] = (node.series_ids.tolist()
                           if node.series_ids is not None else [])
    else:
        d["csl"] = list(node.csl)
        # pack nodes can be shared among sids: serialize each once
        uniq: dict[int, int] = {}
        nodes_json, edges = [], []
        for sid, child in sorted(node.children.items()):
            key = id(child)
            if key not in uniq:
                uniq[key] = len(nodes_json)
                nodes_json.append(_tree_to_json(child))
            edges.append([sid, uniq[key]])
        d["child_nodes"] = nodes_json
        d["edges"] = edges
    return d


def _tree_from_json(d: dict) -> TreeNode:
    node = TreeNode(np.asarray(d["sym"], np.int64),
                    np.asarray(d["card"], np.int64), d["depth"])
    node.size = d["size"]
    node.n_leaves = d["n_leaves"]
    node.is_pack = d["is_pack"]
    node.pack_mask = d["pack_mask"]
    node.pack_value = d["pack_value"]
    if "csl" in d:
        node.csl = tuple(d["csl"])
        kids = [_tree_from_json(c) for c in d["child_nodes"]]
        for sid, ki in d["edges"]:
            node.children[sid] = kids[ki]
            node.routing[sid] = kids[ki]
    else:
        node.series_ids = np.asarray(d["series_ids"], np.int64)
    return node
