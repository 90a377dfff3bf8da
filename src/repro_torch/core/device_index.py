"""DeviceIndex — every device-side array of a built Dumpy index, as one
frozen dataclass of torch tensors (port of ``repro.core.device_index``).

* the ordered collection, tombstone mask and original-id table live in a
  ``[S, Tp, n]`` *leaf-aligned* shard layout: leaves are partitioned into
  ``S`` contiguous groups cut only at leaf boundaries (so every leaf pack
  stays contiguous inside one shard) and each shard is padded to the common
  row count ``Tp`` (pad rows: ``alive=False``, ``id=-1``, zero series).
  ``S`` is a leading batch axis on one device, or, once the index is
  placed on a mesh (:meth:`DeviceIndex.shard`), a tuple of ``S`` tensors
  ``[Tp, ...]``, shard ``s`` on ``mesh.devices[s]`` (``dev.db[s]`` reads
  the same in both forms);
* per-shard leaf MINDIST envelopes (``+inf`` pad leaf) and the fixed-size
  span schedule (windows + (leaf, window)-intersection edges) let each
  shard run the windowed-pruning loop on its own;
* the global leaf table, the flattened routing tables and the sibling
  routing tables serve the approximate and extended searches (the batched
  descent and the sibling schedule of ``search_device``); the layout
  equals the reference's field by field.

On a mesh every global table sits on each distinct device of the mesh
(:meth:`DeviceIndex.on`), the first device being the index's ``device``,
where the merges run.  Index tables keep the reference's ``int32``
storage; the search casts to ``int64`` only where torch indexes with them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (index.py builds us)
    from .index import DumpyIndex


# Array fields, in the reference's order (the first ten are per shard).
_ARRAY_FIELDS = (
    "db", "alive", "ids",
    "leaf_lo", "leaf_hi",
    "win_start", "win_lead", "win_size", "edge_leaf", "edge_win",
    "leaf_start", "leaf_size", "leaf_lo_g", "leaf_hi_g", "inv_order",
    "node_csl", "node_shift", "node_lam",
    "rt_parent", "rt_sid", "rt_leaf", "rt_child", "rt_lo", "rt_hi",
    "rt_nl", "rt_begin", "rt_end",
    "node_begin", "node_end", "leaf_parent",
    "grp_off", "grp_begin", "grp_end", "grp_lo", "grp_hi",
)
#: the per-shard fields: [S, ...] tensors, or tuples of S tensors on a mesh
_SHARDED_FIELDS = _ARRAY_FIELDS[:10]
_META_FIELDS = ("n", "w", "chunk", "depth", "lmax", "total",
                "has_duplicates", "max_replica", "row_bounds",
                "gmax", "leaf_bounds", "shard_health")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises where CUDA is absent, rather than running elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: repro_torch runs on the GPU by default; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return device


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # e.g. the sharded rows of from_index
        return a.to(device)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:        # e.g. np.asarray of a jax.Array
        a = a.copy()
    return torch.from_numpy(a).to(device)


@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    # -- per shard ([S, ...], leaf-aligned; S-tuples on a mesh) --------------
    db: torch.Tensor          # [S, Tp, n] f32 ordered collection (zero pad)
    alive: torch.Tensor       # [S, Tp] bool tombstone mask (False pad)
    ids: torch.Tensor         # [S, Tp] i32 original ids (-1 pad)
    leaf_lo: torch.Tensor     # [S, Lp, w] f32 per-shard leaf envelopes (+inf pad)
    leaf_hi: torch.Tensor     # [S, Lp, w] f32
    win_start: torch.Tensor   # [S, W] i32 span schedule (clamped starts)
    win_lead: torch.Tensor    # [S, W] i32 masked prefix of end-clamped spans
    win_size: torch.Tensor    # [S, W] i32 live rows per span (0 = pad span)
    edge_leaf: torch.Tensor   # [S, E] i32 (local leaf, span) intersections;
    edge_win: torch.Tensor    # [S, E] i32 pads point at the +inf pad leaf
    # -- global ---------------------------------------------------------------
    leaf_start: torch.Tensor  # [L] i32 leaf start in flattened S*Tp coordinates
    leaf_size: torch.Tensor   # [L] i32
    leaf_lo_g: torch.Tensor   # [L, w] f32 global leaf envelopes
    leaf_hi_g: torch.Tensor   # [L, w] f32
    inv_order: torch.Tensor   # [N] i32 original id -> first flattened row (-1 dead pad)
    node_csl: torch.Tensor    # [M, lam_max] i32 routing: chosen segments
    node_shift: torch.Tensor  # [M, lam_max] i32
    node_lam: torch.Tensor    # [M] i32
    rt_parent: torch.Tensor   # [Eg] i32 routing edge list (grouped by parent)
    rt_sid: torch.Tensor      # [Eg] i32
    rt_leaf: torch.Tensor     # [Eg] i32
    rt_child: torch.Tensor    # [Eg] i32
    rt_lo: torch.Tensor       # [Eg, w] f32 child region bounds
    rt_hi: torch.Tensor       # [Eg, w] f32
    rt_nl: torch.Tensor       # [Eg] i32 #leaves under the edge target
    rt_begin: torch.Tensor    # [Eg] i32 contiguous leaf span of the target
    rt_end: torch.Tensor      # [Eg] i32
    node_begin: torch.Tensor  # [M] i32 per-internal-node subtree leaf span
    node_end: torch.Tensor    # [M] i32
    leaf_parent: torch.Tensor  # [L] i32 parent internal node (-1: root leaf)
    grp_off: torch.Tensor     # [M+1] i32 distinct-children group offsets
    grp_begin: torch.Tensor   # [G+gmax] i32 member spans, begin-sorted per
    grp_end: torch.Tensor     # [G+gmax] i32 group; gmax sentinel pad rows
    grp_lo: torch.Tensor      # [G+gmax, w] f32
    grp_hi: torch.Tensor      # [G+gmax, w] f32
    # -- static -----------------------------------------------------------------
    n: int                 # series length
    w: int                 # SAX word length
    chunk: int             # effective span size of the schedule
    depth: int             # routing descent depth
    lmax: int              # max leaf size (approximate-path scan width)
    total: int             # real (unpadded) ordered rows
    has_duplicates: bool   # fuzzy layout -> top-k needs the replica margin
    max_replica: int
    row_bounds: tuple      # S+1 ordered-row cuts (leaf-aligned, host ints)
    gmax: int              # max distinct children of any internal node
    leaf_bounds: tuple     # S+1 leaf-id cuts matching row_bounds
    # ``None`` = all shards healthy; a tuple of S bools masks dead shards
    # out of every merge (degraded mode)
    shard_health: tuple | None = None
    # the mesh the shards are placed on (``None``: every field on one
    # device), and the global tables' copies on its other distinct devices
    mesh: object = None
    replicas: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    # -- shapes --------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        """Where the global tables live and the shard results merge (the
        mesh's first device)."""
        return self.leaf_start.device

    @property
    def n_shards(self) -> int:
        return len(self.row_bounds) - 1

    @property
    def n_live_shards(self) -> int:
        if self.shard_health is None:
            return self.n_shards
        return sum(bool(h) for h in self.shard_health)

    @property
    def shard_rows(self) -> int:
        rb = self.row_bounds
        return max(max(rb[s + 1] - rb[s] for s in range(self.n_shards)), 1)

    def shard_device(self, s: int) -> torch.device:
        """The device that holds shard ``s``."""
        return self.mesh.devices[s] if self.mesh is not None else self.device

    def on(self, device: torch.device) -> "DeviceIndex":
        """This index with its global tables on ``device`` (one of the
        mesh's devices): the copies :meth:`shard` made, no new one."""
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(self, **self.replicas[device])

    @property
    def n_leaves(self) -> int:
        return self.leaf_start.shape[0]

    @property
    def health_mask(self) -> torch.Tensor | None:
        """``shard_health`` as a bool ``[S]`` tensor on the device (``None``
        when every shard is healthy), uploaded on first use and kept: a
        search reads it on every call, and an upload from pageable memory
        waits for the work already queued on the stream."""
        if self.shard_health is None:
            return None
        mask = self.__dict__.get("_health_mask")
        if mask is None:
            mask = torch.tensor(self.shard_health, dtype=torch.bool
                                ).to(self.device)
            object.__setattr__(self, "_health_mask", mask)
        return mask

    # -- construction --------------------------------------------------------
    @classmethod
    def from_arrays(cls, arrays: dict[str, np.ndarray], meta: dict,
                    device: str | torch.device = "cuda") -> "DeviceIndex":
        """Carry a layout across: ``arrays`` holds every field of
        :data:`_ARRAY_FIELDS` as a numpy array (for example the fields of the
        reference's ``DeviceIndex``, read with ``np.asarray``) or a tensor
        (moved to ``device`` if it is elsewhere), ``meta`` the
        static fields of :data:`_META_FIELDS` (``shard_health`` optional).
        Dtypes are kept; tuples in ``meta`` are normalized to host ints."""
        device = resolve_device(device)
        missing = [f for f in _ARRAY_FIELDS if f not in arrays]
        if missing:
            raise ValueError(f"from_arrays: missing array fields {missing}")
        kw = {f: _to_tensor(arrays[f], device) for f in _ARRAY_FIELDS}
        for f in _META_FIELDS:
            if f == "shard_health":
                continue
            if f not in meta:
                raise ValueError(f"from_arrays: missing static field {f!r}")
            kw[f] = meta[f]
        kw["row_bounds"] = tuple(int(c) for c in meta["row_bounds"])  # lint: allow-sync: host ints
        kw["leaf_bounds"] = tuple(int(c) for c in meta["leaf_bounds"])  # lint: allow-sync: host ints
        dev = cls(**kw)
        return dev.with_shard_health(meta.get("shard_health"))

    @classmethod
    def from_index(cls, index: "DumpyIndex", chunk: int = 2048,
                   n_shards: int = 1,
                   device: str | torch.device = "cuda", *,
                   db_device: torch.Tensor | None = None) -> "DeviceIndex":
        """Build the full device state from a host ``DumpyIndex``.

        ``n_shards`` fixes the leading axis; the shard boundaries are the
        leaf boundaries nearest the ideal ``total/S`` cuts, so a leaf never
        straddles two shards and the span loop needs no cross-shard windows.

        ``db_device`` — optional ``[total, n]`` tensor already in
        leaf-contiguous order (the device build's gather output): the data
        plane is then assembled on the device and the host ``db_ordered``
        permutation is never materialized.  Without it the host rows are
        padded into shards on the host and uploaded.
        """
        device = resolve_device(device)
        arrays, meta = layout_arrays(index, chunk, n_shards)
        rows = (db_device.to(device) if db_device is not None
                else torch.from_numpy(index.db_ordered))
        arrays["db"] = _shard_rows(rows, meta["row_bounds"])
        return cls.from_arrays(arrays, meta, device)

    # -- placement -------------------------------------------------------------
    def shard(self, mesh) -> "DeviceIndex":
        """Place the index on ``mesh`` (the reference's ``shard``): shard
        ``s`` of every per-shard field goes to ``mesh.devices[s]`` as a
        ``[Tp, ...]`` tensor (a view where it is already there), and every
        global table is copied once to each distinct device of the mesh.
        ``n_shards`` must equal the mesh's size."""
        if mesh.size != self.n_shards:
            raise ValueError(
                f"a mesh of {mesh.size} devices for {self.n_shards} shards")
        home = mesh.devices[0]
        kw = {f: tuple(getattr(self, f)[s].to(d)
                       for s, d in enumerate(mesh.devices))
              for f in _SHARDED_FIELDS}
        glob = _ARRAY_FIELDS[len(_SHARDED_FIELDS):]
        kw.update({f: getattr(self, f).to(home) for f in glob})
        replicas = {d: {f: kw[f].to(d) for f in glob}
                    for d in mesh.distinct[1:]}
        return dataclasses.replace(self, mesh=mesh, replicas=replicas, **kw)

    # -- incremental state ---------------------------------------------------
    def with_shard_health(self, health) -> "DeviceIndex":
        """Mark shards dead/alive for degraded-mode search.  ``health`` is a
        length-``n_shards`` boolean sequence (or ``None`` to clear); all-True
        canonicalizes to ``None``."""
        if health is None:
            return dataclasses.replace(self, shard_health=None)
        health = tuple(bool(h) for h in health)
        if len(health) != self.n_shards:
            raise ValueError(
                f"shard_health has {len(health)} entries for "
                f"{self.n_shards} shards")
        if not any(health):
            raise ValueError("shard_health marks every shard dead — "
                             "no data left to search")
        if all(health):
            health = None
        return dataclasses.replace(self, shard_health=health)

    def with_alive(self, alive_by_id: np.ndarray) -> "DeviceIndex":
        """Re-derive the padded tombstone mask from the host per-id ``alive``
        vector (deletions/undeletions without rebuilding the layout).  Every
        fuzzy replica of a dead id dies with it."""
        ids_np = np.stack([t.cpu().numpy() for t in self.ids])  # lint: allow-sync: once a shard
        new = np.zeros(ids_np.shape, bool)
        m = ids_np >= 0
        new[m] = np.asarray(alive_by_id, bool)[ids_np[m]]
        if self.mesh is None:
            alive = torch.from_numpy(new).to(self.device)
        else:
            alive = tuple(torch.from_numpy(new[s]).to(d)
                          for s, d in enumerate(self.mesh.devices))
        return dataclasses.replace(self, alive=alive)


def _shard_rows(rows: torch.Tensor, row_bounds: tuple) -> torch.Tensor:
    """``[total, n]`` ordered rows → the ``[S, Tp, n]`` shard layout, on the
    rows' device (zero pad rows).  One unpadded shard is a view."""
    S = len(row_bounds) - 1
    sizes = [row_bounds[s + 1] - row_bounds[s] for s in range(S)]
    Tp = max(max(sizes), 1)
    if S == 1 and sizes[0] == Tp:
        return rows[None]
    out = rows.new_zeros((S, Tp, rows.shape[1]))
    for s in range(S):
        out[s, :sizes[s]] = rows[row_bounds[s]:row_bounds[s + 1]]
    return out


def layout_arrays(index: "DumpyIndex", chunk: int = 2048, n_shards: int = 1
                  ) -> tuple[dict[str, np.ndarray], dict]:
    """The host half of :meth:`DeviceIndex.from_index`: every field but the
    data plane ``db`` (:func:`_shard_rows`) as a numpy array, plus the
    static fields (the reference's construction, verbatim)."""
    flat = index.flat
    offs = np.asarray(flat.leaf_offsets, np.int64)
    L = flat.n_leaves
    total = int(offs[-1])
    n = index.db.shape[1]
    w = flat.leaf_lo.shape[1]
    S = max(int(n_shards), 1)

    # leaf-aligned cuts: the leaf boundary nearest each ideal row split
    cut_leaf = [0]
    for s in range(1, S):
        ideal = s * total / S
        j = int(np.searchsorted(offs, ideal))
        if j > 0 and (j > L or ideal - float(offs[j - 1])
                      < float(offs[j]) - ideal):
            j -= 1
        cut_leaf.append(min(max(j, cut_leaf[-1]), L))
    cut_leaf.append(L)
    row_bounds = tuple(int(offs[c]) for c in cut_leaf)

    Tp = max(max(row_bounds[s + 1] - row_bounds[s] for s in range(S)), 1)
    chunk_eff = max(min(int(chunk), Tp), 1)
    W = math.ceil(Tp / chunk_eff)
    Lp = max(cut_leaf[s + 1] - cut_leaf[s] for s in range(S)) + 1  # +pad

    alive_sh = np.zeros((S, Tp), bool)
    ids_sh = np.full((S, Tp), -1, np.int32)
    lo_sh = np.full((S, Lp, w), np.inf, np.float32)
    hi_sh = np.full((S, Lp, w), np.inf, np.float32)
    win_start = np.zeros((S, W), np.int32)
    win_lead = np.zeros((S, W), np.int32)
    win_size = np.zeros((S, W), np.int32)
    edges: list[tuple[list, list]] = []

    order = np.asarray(flat.order, np.int64)
    alive_ord = index.alive[order]
    pos_flat = np.empty(total, np.int64)   # ordered row -> flattened row
    for s in range(S):
        r0, r1 = row_bounds[s], row_bounds[s + 1]
        l0, l1 = cut_leaf[s], cut_leaf[s + 1]
        Ts = r1 - r0
        alive_sh[s, :Ts] = alive_ord[r0:r1]
        ids_sh[s, :Ts] = order[r0:r1]
        lo_sh[s, :l1 - l0] = flat.leaf_lo[l0:l1]
        hi_sh[s, :l1 - l0] = flat.leaf_hi[l0:l1]
        pos_flat[r0:r1] = s * Tp + np.arange(Ts)
        local_offs = offs[l0:l1 + 1] - r0
        el, ew = [], []
        for wi, w0 in enumerate(range(0, Tp, chunk_eff)):
            st = min(w0, max(Tp - chunk_eff, 0))
            size = min(max(Ts - w0, 0), chunk_eff)
            win_start[s, wi] = st
            win_lead[s, wi] = w0 - st
            win_size[s, wi] = size
            if size > 0:
                la = int(np.searchsorted(local_offs, w0, "right")) - 1
                lb = int(np.searchsorted(local_offs, w0 + size, "left"))
                for lid in range(max(la, 0), lb):
                    el.append(lid)
                    ew.append(wi)
        edges.append((el, ew))

    # pad edges aim at the +inf pad leaf / the last span: segment-min
    # treats them as no-ops, and edge_win stays sorted
    E = max(max(len(el) for el, _ in edges), 1)
    edge_leaf = np.full((S, E), Lp - 1, np.int32)
    edge_win = np.full((S, E), W - 1, np.int32)
    for s, (el, ew) in enumerate(edges):
        edge_leaf[s, :len(el)] = el
        edge_win[s, :len(ew)] = ew

    leaf_start = np.zeros(max(L, 1), np.int32)
    for s in range(S):
        l0, l1 = cut_leaf[s], cut_leaf[s + 1]
        leaf_start[l0:l1] = s * Tp + (offs[l0:l1] - row_bounds[s])
    leaf_size = np.diff(offs).astype(np.int32) if L else np.ones(1, np.int32)

    inv = np.full(index.db.shape[0], -1, np.int64)
    inv[order[::-1]] = pos_flat[::-1]       # first replica wins

    rt = index.routing_flat
    gmax = rt.gmax
    # gmax sentinel rows so a fixed-width slice of any group stays in
    # bounds: begin/end = i32 max, bounds = +inf
    big = np.iinfo(np.int32).max
    arrays = dict(
        alive=alive_sh, ids=ids_sh, leaf_lo=lo_sh, leaf_hi=hi_sh,
        win_start=win_start, win_lead=win_lead, win_size=win_size,
        edge_leaf=edge_leaf, edge_win=edge_win,
        leaf_start=leaf_start, leaf_size=leaf_size,
        leaf_lo_g=flat.leaf_lo, leaf_hi_g=flat.leaf_hi,
        inv_order=inv.astype(np.int32),
        node_csl=rt.node_csl, node_shift=rt.node_shift, node_lam=rt.node_lam,
        rt_parent=rt.edge_parent, rt_sid=rt.edge_sid.astype(np.int32),
        rt_leaf=rt.edge_leaf, rt_child=rt.edge_child,
        rt_lo=rt.edge_lo, rt_hi=rt.edge_hi,
        rt_nl=rt.edge_nl, rt_begin=rt.edge_begin, rt_end=rt.edge_end,
        node_begin=rt.node_begin, node_end=rt.node_end,
        leaf_parent=rt.leaf_parent, grp_off=rt.grp_off,
        grp_begin=np.concatenate([rt.grp_begin, np.full(gmax, big, np.int32)]),
        grp_end=np.concatenate([rt.grp_end, np.full(gmax, big, np.int32)]),
        grp_lo=np.concatenate([rt.grp_lo,
                               np.full((gmax, w), np.inf, np.float32)]),
        grp_hi=np.concatenate([rt.grp_hi,
                               np.full((gmax, w), np.inf, np.float32)]),
    )
    meta = dict(
        n=n, w=w, chunk=chunk_eff, depth=rt.depth,
        lmax=max(int(np.diff(offs).max()) if L else 1, 1),
        total=total,
        has_duplicates=index.stats.n_duplicates > 0,
        max_replica=int(index.params.max_replica),
        row_bounds=row_bounds, gmax=gmax,
        leaf_bounds=tuple(int(c) for c in cut_leaf),
    )
    return arrays, meta


def abstract_device_index(n_series: int, length: int, w: int, *,
                          n_shards: int = 1, chunk: int = 4096,
                          n_leaves: int = 4096, lam_max: int = 4,
                          depth: int = 8, gmax: int = 64,
                          shard_health: tuple | None = None,
                          shard_local: bool = False,
                          device: str | torch.device = "cuda"
                          ) -> DeviceIndex:
    """A ``DeviceIndex`` of fake tensors for the dry run (the reference's
    ``ShapeDtypeStruct``-leaved index): equal-sized leaves, evenly divided
    shards, shapes and dtypes only, made in the active ``FakeTensorMode``
    or a new one.  With ``shard_local`` the per-shard fields hold one shard
    (``[1, Tp, ...]``: one device's part of a mesh of ``n_shards``), the
    global tables whole.  CUDA unless the caller asks for the CPU."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    device = resolve_device(device)
    S = max(int(n_shards), 1)
    Tp = math.ceil(n_series / S)
    Ls = math.ceil(n_leaves / S)
    Lp = Ls + 1
    chunk_eff = max(min(int(chunk), Tp), 1)
    W = math.ceil(Tp / chunk_eff)
    E = Ls + W
    M = max(n_leaves // 4, 1)
    Eg = max(n_leaves, 1)
    G = Eg + gmax
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    S_here = 1 if shard_local else S
    with detect_fake_mode() or FakeTensorMode():
        def t(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=device)
        arrays = dict(
            db=t((S_here, Tp, length), f32), alive=t((S_here, Tp), b8),
            ids=t((S_here, Tp), i32),
            leaf_lo=t((S_here, Lp, w), f32), leaf_hi=t((S_here, Lp, w), f32),
            win_start=t((S_here, W), i32), win_lead=t((S_here, W), i32),
            win_size=t((S_here, W), i32),
            edge_leaf=t((S_here, E), i32), edge_win=t((S_here, E), i32),
            leaf_start=t((n_leaves,), i32), leaf_size=t((n_leaves,), i32),
            leaf_lo_g=t((n_leaves, w), f32), leaf_hi_g=t((n_leaves, w), f32),
            inv_order=t((n_series,), i32),
            node_csl=t((M, lam_max), i32), node_shift=t((M, lam_max), i32),
            node_lam=t((M,), i32),
            rt_parent=t((Eg,), i32), rt_sid=t((Eg,), i32),
            rt_leaf=t((Eg,), i32), rt_child=t((Eg,), i32),
            rt_lo=t((Eg, w), f32), rt_hi=t((Eg, w), f32),
            rt_nl=t((Eg,), i32), rt_begin=t((Eg,), i32),
            rt_end=t((Eg,), i32),
            node_begin=t((M,), i32), node_end=t((M,), i32),
            leaf_parent=t((n_leaves,), i32),
            grp_off=t((M + 1,), i32),
            grp_begin=t((G,), i32), grp_end=t((G,), i32),
            grp_lo=t((G, w), f32), grp_hi=t((G, w), f32))
    if shard_local:
        row_bounds, leaf_bounds = (0, Tp), (0, Ls)
        shard_health = None
    else:
        row_bounds = tuple(min(s * Tp, n_series) for s in range(S + 1))
        leaf_bounds = tuple(min(s * Ls, n_leaves) for s in range(S + 1))
    return DeviceIndex(
        **arrays, n=length, w=w, chunk=chunk_eff, depth=depth,
        lmax=max(math.ceil(n_series / max(n_leaves, 1)), 1),
        total=n_series, has_duplicates=False, max_replica=3,
        row_bounds=row_bounds, gmax=gmax, leaf_bounds=leaf_bounds,
        shard_health=shard_health)
