"""Distributed Dumpy: index building and search over a device mesh (port of
``repro.core.distributed``).

The paper's Algorithm 1 maps onto the mesh
(:class:`~repro_torch.distributed.sharding.Mesh`, one ``"data"`` axis) as
in the reference:

* **Stage 1 (SAX table)**: the collection is cut into row shards, one per
  mesh entry, and ``sax_encode`` (the CUDA kernel) runs on each shard's
  device;
* **root histogram**: next-bit codes → ``bincount(2**w)`` on each shard's
  device, the partial histograms summed on the mesh's first device (the
  reference's all-reduce: 2**w integers are the only cross-device traffic
  the global split decision needs);
* **subtree builds**: host control flow over the gathered SAX table
  (:class:`~repro_torch.core.build.DumpyBuilder`);
* **search**: the ``DeviceIndex`` shards the ordered collection leaf-aligned
  over the mesh (global tables on every device), each device runs its
  shard's search, and the shard-local top-k lists move to the first device
  for the dedup merge (``core/search_device.py``).

One process drives every device, as the reference's single controller does;
a device may repeat in a mesh (four shards on one card).  ``build_step`` and
``search_step`` are the reference's one-shot device programs.

For the dry run (``repro_torch.launch.dryrun``), the ``lower_*`` helpers
give each cell's device program as a :class:`~repro_torch.distributed.
op_cost.Program` whose ``.analyze()`` counts it on fake tensors (the
counterpart of ``.lower(...).compile()`` and its analyses).  On a named
production mesh (``launch.mesh.production_device_mesh``) a device runs one
shard's program at the shard's shapes, the shard count being the mesh's
pod × data (:func:`_mesh_shards`: 16 shards of 262 144 rows on 16×16, 32
of 131 072 on 2×16×16), and the merge of the shards' ``[Q, k]`` lists
counts as an all-gather of ``(S - 1)·Q·k·8`` bytes.

The exact searches (``search_sharded``, ``search_dtw``,
``search_degraded``) read the device on the host: the span schedule, the
stop tests.  Their dry run is the reference's worst case: each loop's body
runs once on fake tensors and ``op_cost.scaled`` counts it once a trip of
a loop that runs to its end (every span, every LB slab, every walk chunk),
as ``hlo_cost`` scales a ``while`` body by its trip count.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..distributed.sharding import get_mesh, make_mesh
from ..kernels import ops
from .build import DumpyBuilder, DumpyParams
from .index import DumpyIndex, flatten_tree
from .sax import next_bit_codes_t


# ---------------------------------------------------------------------------
# device programs
# ---------------------------------------------------------------------------

def build_step(db_shard: torch.Tensor, w: int, b: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 1 + root histogram of one shard ``[N, n]``, on its device:
    ``(paa [N, w] f32, sax [N, w] i32, hist [2**w] i64)``.  ``sax_encode``
    is the kernel on a CUDA tensor and its plain twin on a CPU tensor; the
    codes are each row's first bit of every segment (cardinality 0)."""
    paa, sax = ops.sax_encode(db_shard, w, b)
    card = torch.zeros(w, dtype=torch.int32, device=sax.device)
    codes = next_bit_codes_t(sax, card, w, b).long()
    # a scatter-add, not torch.bincount: on a CUDA tensor bincount reads the
    # codes' min and max on the host (two syncs), and every code is below
    # 2**w already
    hist = torch.zeros(1 << w, dtype=torch.int64, device=sax.device)
    return paa, sax, hist.index_add_(0, codes, torch.ones_like(codes))


def _topk_lowest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Row-wise positions of the ``k`` smallest values, ascending, the lower
    position first among equal values (``lax.top_k``'s order on ``-d2``):
    one ``torch.topk`` over the int64 key ``(order-preserving bits of d2) ·
    2**32 + position``, whose values are distinct."""
    bits = (d2 + 0.0).view(torch.int32)       # + 0.0: -0.0 becomes +0.0
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)   # float order as int order
    pos = torch.arange(d2.shape[1], dtype=torch.int64, device=d2.device)
    comp = (key.to(torch.int64) << 32) | pos[None, :]
    return torch.topk(comp, k, dim=1, largest=False).values & 0xFFFFFFFF


def search_step(q: torch.Tensor, db_ordered: torch.Tensor,
                leaf_lo: torch.Tensor, leaf_hi: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-shot device kNN over a whole collection ``db_ordered [X, n]`` on
    its device: ``(positions [Q, k] i64, d [Q, k] f32, lbs [Q] f32)``.
    ``lbs`` is each query's smallest squared MINDIST over the leaf table
    ``leaf_lo / leaf_hi [L, w]`` (``lb_isax``, the ``lb_paa_interval``
    kernel); its square root lower-bounds the query's nearest distance.
    Distances come from one ``pairwise_l2`` call over all ``X`` rows, the
    selection keeps the lower position among equal distances."""
    n = db_ordered.shape[1]
    paa_q = q.reshape(q.shape[0], leaf_lo.shape[1], -1).mean(-1)
    lbs = ops.lb_isax(paa_q, leaf_lo, leaf_hi, n)          # [Q, L] squared
    d2 = ops.pairwise_l2(q, db_ordered)                     # [Q, X]
    idx = _topk_lowest(d2, k)
    d = torch.sqrt(torch.clamp_min(torch.gather(d2, 1, idx), 0.0))
    return idx, d, lbs.min(dim=1).values


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------

def _to_host(t: torch.Tensor) -> np.ndarray:
    """A device table gathered to the host."""
    return t.cpu().numpy()


def encode_distributed(db: np.ndarray, w: int, b: int, mesh=None
                       ) -> tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """Stage 1 and the root histogram of :func:`build_distributed`: ``db``
    cut into ``mesh.size`` row shards, :func:`build_step` launched on every
    shard's device before the first gather (so the devices encode at once),
    then the histograms summed on the mesh's first device and the table
    gathered to the host.  Returns ``(paa [N, w] f32, sax [N, w] u8, hist
    [2**w] on mesh.devices[0])``.  Without ``mesh`` and a current mesh, one
    shard on the current CUDA device (raises without CUDA)."""
    if mesh is None:
        mesh = get_mesh() or make_mesh(["cuda"])
    db = np.ascontiguousarray(db, np.float32)
    N = db.shape[0]
    cuts = [s * N // mesh.size for s in range(mesh.size + 1)]
    home = mesh.devices[0]
    steps = [build_step(torch.from_numpy(db[cuts[s]:cuts[s + 1]]).to(d), w, b)
             for s, d in enumerate(mesh.devices)]
    hist = steps[0][2].to(home)
    for _, _, h in steps[1:]:
        hist = hist + h.to(home)                        # the all-reduce
    paa = np.concatenate([_to_host(p) for p, _, _ in steps])
    sax = np.concatenate([_to_host(q).astype(np.uint8) for _, q, _ in steps])
    return paa, sax, hist


def build_distributed(db: np.ndarray, params: DumpyParams | None = None,
                      mesh=None) -> DumpyIndex:
    """Algorithm 1 with Stage 1 and the histogram on the mesh (``mesh``,
    else the current one, else the current CUDA device alone; a mesh of
    ``"cpu"`` entries runs on the CPU), then the host tree build over the
    gathered table."""
    params = params or DumpyParams()
    db = np.ascontiguousarray(db, np.float32)
    params.sax.validate_series_length(db.shape[1])
    w, b = params.sax.w, params.sax.b
    paa, sax, _ = encode_distributed(db, w, b, mesh=mesh)
    # tree construction is host control flow over the (small) SAX table;
    # the builder's root split recounts the histogram from it, as the
    # reference's does
    root, stats = DumpyBuilder(params).build_tree(paa, sax)
    flat = flatten_tree(root, b)
    return DumpyIndex(params, root, flat, db, paa, sax, stats)


def search_distributed(index: DumpyIndex, queries: np.ndarray, k: int,
                       nbr: int | None = None, metric: str = "ed",
                       band: int | None = None, shard_health=None,
                       mesh=None):
    """Sharded kNN: a thin wrapper over the ``DeviceIndex`` search paths.

    On a mesh (``mesh``, else the current one) the index shards leaf-aligned
    over it and each shard runs its search on its own device (shard-local
    top-k, gathered to the first device and merged); without one it is the
    one-shard program on the current CUDA device (raises without CUDA; a
    mesh of ``"cpu"`` entries runs on the CPU).  ``nbr=None`` runs the
    exact windowed-pruning search, an integer the extended search (paper
    Alg. 4, the target subtree plus up to ``nbr-1`` lower-bound-ordered
    sibling leaves).  ``metric``/``band`` select ``"ed"`` or banded
    ``"dtw"``.

    ``shard_health`` (one bool a shard) runs degraded: dead shards are
    masked from the merge and the return becomes ``(ids, d, coverage)``,
    ``coverage`` the live-series fraction still reachable."""
    from .search_device import (exact_search_device_batch,
                                extended_search_device_batch)
    if mesh is None:
        mesh = get_mesh()
    kw = dict(metric=metric, band=band, shard_health=shard_health,
              mesh=mesh)
    if nbr is not None:
        res = extended_search_device_batch(index, queries, k, nbr=nbr, **kw)
    else:
        res = exact_search_device_batch(index, queries, k, **kw)
    if shard_health is not None:
        return res[0], res[1], res[-1]
    return res[0], res[1]


# ---------------------------------------------------------------------------
# the dry run's device programs (counted on fake tensors)
# ---------------------------------------------------------------------------

def _mesh_shards(mesh) -> int:
    """Shards of a Dumpy index on ``mesh``: its pod × data size (the model
    axis replicates)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return sizes.get("pod", 1) * sizes.get("data", 1)


def _merge_collective(mesh, q_batch: int, k: int) -> tuple:
    """The shards' ``[Q, k]`` (distance, id) lists all-gathered for the
    merge: ``(S - 1)·Q·k·8`` bytes into each device."""
    from ..distributed.roofline import GPUS_PER_HOST
    S = _mesh_shards(mesh)
    if S <= 1:
        return ()
    return (("all-gather", (S - 1) * q_batch * k * 8,
             math.prod(mesh.shape) > GPUS_PER_HOST),)


def _fake(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


def _abstract_prep(q_batch: int, w: int, length: int, device):
    """Fake tensors of ``metric.query_prep``'s output (ED and DTW preps
    have one shape: the segment interval and the envelope)."""
    seg = _fake((q_batch, w), torch.float32, device)
    env = _fake((q_batch, length), torch.float32, device)
    return (seg, _fake((q_batch, w), torch.float32, device), env,
            _fake((q_batch, length), torch.float32, device))


def lower_build_step(mesh, *, n_series: int = 1 << 22, length: int = 256,
                     w: int = 16, b: int = 8,
                     device: str | torch.device = "cuda"):
    """Stage 1 + the root histogram (:func:`build_step`) on one shard of
    rows, the partial histograms all-reduced (``2**w`` int64)."""
    from ..distributed.op_cost import Program
    from .device_index import resolve_device
    device = resolve_device(device)
    Tp = math.ceil(n_series / _mesh_shards(mesh))
    S = _mesh_shards(mesh)
    coll = (("all-reduce", 8 * (1 << w), math.prod(mesh.shape) > 8),) \
        if S > 1 else ()
    return Program(lambda db: build_step(db, w, b),
                   lambda: (_fake((Tp, length), torch.float32, device),),
                   coll)


def lower_build_bottomup(mesh, *, n_series: int = 1 << 22, w: int = 16,
                         b: int = 8, device: str | torch.device = "cuda"):
    """The bottom-up device build's grouping program
    (``build_device._lexsort_words``: packed-word stable sorts and group
    delimiting) over the whole table; collective-free."""
    from ..distributed.op_cost import Program
    from .build_device import _lexsort_words
    from .device_index import resolve_device
    device = resolve_device(device)
    return Program(lambda s: _lexsort_words(s, w, b),
                   lambda: (_fake((n_series, w), torch.uint8, device),))


def lower_search_oneshot(mesh, *, n_series: int = 1 << 22,
                         length: int = 256, w: int = 16,
                         n_leaves: int = 16384, k: int = 50,
                         q_batch: int = 64,
                         device: str | torch.device = "cuda"):
    """The one-shot LB scan + exact distances (:func:`search_step`) over one
    shard of the collection, then the merge."""
    from ..distributed.op_cost import Program
    from .device_index import resolve_device
    device = resolve_device(device)
    Tp = math.ceil(n_series / _mesh_shards(mesh))
    return Program(
        lambda q, db, lo, hi: search_step(q, db, lo, hi, k),
        lambda: (_fake((q_batch, length), torch.float32, device),
                 _fake((Tp, length), torch.float32, device),
                 _fake((n_leaves, w), torch.float32, device),
                 _fake((n_leaves, w), torch.float32, device)),
        _merge_collective(mesh, q_batch, k))


def _index_args(mesh, n_series, length, w, chunk, n_leaves, q_batch,
                device, *extra):
    from .device_index import abstract_device_index
    dev = abstract_device_index(n_series, length, w,
                                n_shards=_mesh_shards(mesh), chunk=chunk,
                                n_leaves=n_leaves, shard_local=True,
                                device=device)
    return (dev, _abstract_prep(q_batch, w, length, device)) + tuple(
        _fake(s, dt, device) for s, dt in extra)


def _shard_knn_counted(dev, s: int, prep: tuple, qs: torch.Tensor, k: int,
                       metric):
    """``search_device._shard_knn`` as the dry run counts it → ``(topd,
    topi, vis, stats)``: the prologue, then one span counted W times, the
    worst case (every span runs: start ``i·chunk``, lead 0, ``chunk`` rows
    alive); no schedule download, no stop test."""
    from ..distributed import op_cost
    from .search_device import _span_carry, _span_prologue, _span_step
    slabs, n_sub, win_lb, _, _ = _span_prologue(dev, s, prep, qs, metric)
    carry = _span_carry(qs.shape[0], k, qs.device)
    return op_cost.scaled("span", win_lb.shape[1], _span_step, metric, qs,
                          prep, slabs, win_lb, dev.chunk, n_sub, carry, 0, 0,
                          0, dev.chunk)


def _lb_tables_counted(db_s, alive_s, qs, env_lo, env_hi, r: int) -> tuple:
    """Stage 1 of ``search_device._lane_knn``: one LB slab counted once a
    slab."""
    from ..distributed import op_cost
    from .search_device import _lb_init, _lb_slab, _lb_trips
    Tp = db_s.shape[0]
    tables = _lb_init(qs.shape[0], Tp, qs.device)
    return op_cost.scaled("lb_slab", _lb_trips(Tp), _lb_slab, db_s, alive_s,
                          qs, env_lo, env_hi, r, tables, 0)


def _lane_walk_counted(db_s, ids_s, qs, order, lbi_s, lbk_s, topd, topi,
                       r: int, kseed: int):
    """``search_device._lane_walk``: one chunk counted once a chunk to the
    last lane (the flag that stops the walk never falls)."""
    from ..distributed import op_cost
    from .search_device import _walk_init, _walk_step
    _, NC, cols, carry = _walk_init(order, topd, topi, kseed)
    if NC:
        carry = op_cost.scaled("walk", NC, _walk_step, db_s, ids_s, qs,
                               order, lbi_s, lbk_s, cols, r, kseed, carry, 0)
    return carry[:4]


def exact_counted(dev, prep: tuple, qs: torch.Tensor, *, k: int, metric,
                  n_shards: int = 1, shard_health=None):
    """One device's exact search (``search_device._exact_knn_sharded``) as
    the dry run counts it: shard 0 of ``dev`` through its loops counted by
    trip count (the span program, or for DTW ``perq`` / ``cluster`` the
    lane program with its LB slabs and walk), the other ``n_shards - 1``
    shards' lists as the all-gather delivers them, then the merge with
    ``shard_health``'s dead shards masked."""
    from .search_device import _drive, _finished, _lane_knn, _merge_shards
    if metric.is_dtw and metric.order != "shared":
        (part,), _ = _drive([_lane_knn(
            dev, 0, prep, qs, k, metric, tables=_lb_tables_counted,
            walk=lambda *a: _finished(_lane_walk_counted(*a)))])
    else:
        part = _shard_knn_counted(dev, 0, prep, qs, k, metric)
    parts = [part[:4]] + [tuple(torch.empty_like(t) for t in part[:4])
                          for _ in range(n_shards - 1)]
    merge_dev = dataclasses.replace(dev, shard_health=shard_health)
    return _merge_shards(merge_dev, parts, qs.shape[0], k)


def _exact_program(make_args, *, k: int, metric, n_shards: int,
                   shard_health, collectives: tuple):
    from ..distributed.op_cost import Program
    return Program(
        lambda d, prep, q: exact_counted(d, prep, q, k=k, metric=metric,
                                         n_shards=n_shards,
                                         shard_health=shard_health),
        make_args, collectives)


def lower_search_sharded(mesh, *, n_series: int = 1 << 22,
                         length: int = 256, w: int = 16, chunk: int = 8192,
                         n_leaves: int = 16384, k: int = 58,
                         q_batch: int = 64, metric=None,
                         shard_health: tuple | None = None,
                         device: str | torch.device = "cuda"):
    """The sharded exact search (:func:`exact_counted`: ED, or DTW with
    ``metric``) on one shard, then the merge; ``shard_health`` (one bool a
    mesh shard) masks dead shards out of it."""
    from .device_index import resolve_device
    from .metric import ED
    device = resolve_device(device)
    S = _mesh_shards(mesh)
    health = None if shard_health is None or all(shard_health) \
        else tuple(shard_health)
    return _exact_program(
        lambda: _index_args(mesh, n_series, length, w, chunk, n_leaves,
                            q_batch, device,
                            ((q_batch, length), torch.float32)),
        k=k, metric=metric or ED, n_shards=S, shard_health=health,
        collectives=_merge_collective(mesh, q_batch, k))


def lower_search_dtw(mesh, *, n_series: int = 1 << 22, length: int = 256,
                     w: int = 16, chunk: int | None = None,
                     n_leaves: int = 16384, k: int = 58, q_batch: int = 64,
                     band: int | None = None, order: str = "shared",
                     device: str | torch.device = "cuda"):
    """The sharded exact DTW search: ``order`` ``"shared"`` counts the span
    program (``DTW_SUB``-row sub-slabs), ``"perq"`` / ``"cluster"`` the
    lane program; the chunk defaults to 8192, the band to ``0.1·length``."""
    from .metric import Metric, default_band
    return lower_search_sharded(
        mesh, n_series=n_series, length=length, w=w,
        chunk=chunk if chunk is not None else 8192, n_leaves=n_leaves, k=k,
        q_batch=q_batch, device=device,
        metric=Metric("dtw", band if band is not None
                      else default_band(length), order))


def lower_search_degraded(mesh, *, n_series: int = 1 << 22,
                          length: int = 256, w: int = 16, chunk: int = 8192,
                          n_leaves: int = 16384, k: int = 58,
                          q_batch: int = 64,
                          device: str | torch.device = "cuda"):
    """The exact ED search with the last mesh shard dead (healthy on a mesh
    of one shard)."""
    S = _mesh_shards(mesh)
    health = (True,) * (S - 1) + (False,) if S > 1 else None
    return lower_search_sharded(mesh, n_series=n_series, length=length, w=w,
                                chunk=chunk, n_leaves=n_leaves, k=k,
                                q_batch=q_batch, shard_health=health,
                                device=device)


def lower_exact_on(dev, *, k: int, q_batch: int, metric=None):
    """The exact search's count on fake copies of a real one-device layout
    ``dev`` (a 1 × 1 mesh): the loops' trip counts are that layout's W and
    Tp."""
    from torch._guards import detect_fake_mode

    from .device_index import _ARRAY_FIELDS
    from .metric import ED

    def args():
        mode = detect_fake_mode()
        fake = dataclasses.replace(
            dev, mesh=None, replicas={},
            **{f: mode.from_tensor(getattr(dev, f)) for f in _ARRAY_FIELDS})
        return (fake, _abstract_prep(q_batch, dev.w, dev.n, dev.device),
                _fake((q_batch, dev.n), torch.float32, dev.device))

    return _exact_program(args, k=k, metric=metric or ED, n_shards=1,
                          shard_health=None, collectives=())


def lower_search_extended(mesh, *, n_series: int = 1 << 22,
                          length: int = 256, w: int = 16, chunk: int = 8192,
                          n_leaves: int = 16384, k: int = 58, nbr: int = 8,
                          q_batch: int = 64,
                          device: str | torch.device = "cuda"):
    """The batched extended search (Alg. 4 descent, sibling schedule, leaf
    scan: ``search_device._extended_knn_sharded``) on one shard, then the
    merge."""
    from ..distributed.op_cost import Program
    from .device_index import resolve_device
    from .search_device import _extended_knn_sharded
    device = resolve_device(device)
    return Program(
        lambda d, prep, sq, q: _extended_knn_sharded(
            d, prep, sq, q, k=k, nbr=nbr, subtree=True),
        lambda: _index_args(mesh, n_series, length, w, chunk, n_leaves,
                            q_batch, device,
                            ((q_batch, w), torch.int32),
                            ((q_batch, length), torch.float32)),
        _merge_collective(mesh, q_batch, k))


def lower_search_approx(mesh, *, n_series: int = 1 << 22,
                        length: int = 256, w: int = 16, chunk: int = 8192,
                        n_leaves: int = 16384, k: int = 58, nbr: int = 4,
                        q_batch: int = 64, metric=None,
                        device: str | torch.device = "cuda"):
    """The batched approximate search (descent + leaf-rank scan:
    ``search_device._approx_knn_device``) on one shard, then the merge."""
    from ..distributed.op_cost import Program
    from .device_index import resolve_device
    from .metric import ED
    from .search_device import _approx_knn_device
    device = resolve_device(device)
    met = metric or ED
    return Program(
        lambda d, prep, sq, q: _approx_knn_device(
            d, prep, sq, q, k=k, kk=k, nbr=nbr, metric=met),
        lambda: _index_args(mesh, n_series, length, w, chunk, n_leaves,
                            q_batch, device,
                            ((q_batch, w), torch.int32),
                            ((q_batch, length), torch.float32)),
        _merge_collective(mesh, q_batch, k))


def lower_search_bucket(mesh, *, n_series: int = 1 << 22,
                        length: int = 256, w: int = 16, chunk: int = 8192,
                        n_leaves: int = 16384, k: int = 58, nbr: int = 8,
                        q_batch: int = 64, band: int | None = None,
                        device: str | torch.device = "cuda"):
    """The bucketed serving program (``search_device._bucket_knn_sharded``,
    the mixed ED/DTW variant) on one shard, then the merge."""
    from ..distributed.op_cost import Program
    from .device_index import resolve_device
    from .metric import default_band
    from .search_device import _bucket_knn_sharded
    device = resolve_device(device)
    band_eff = band if band is not None else default_band(length)

    def args():
        dev, prep, sq, q, ln, ld = _index_args(
            mesh, n_series, length, w, chunk, n_leaves, q_batch, device,
            ((q_batch, w), torch.int32), ((q_batch, length), torch.float32),
            ((q_batch,), torch.int32), ((q_batch,), torch.bool))
        return dev, prep, _abstract_prep(q_batch, w, length, device), sq, \
            q, ln, ld

    return Program(
        lambda d, pe, pd, sq, q, ln, ld: _bucket_knn_sharded(
            d, pe, pd, sq, q, ln, ld, kk=k, nbr_max=nbr, subtree=True,
            band=band_eff, has_dtw=True),
        args, _merge_collective(mesh, q_batch, k))


def lower_serving_head(mesh, *, vocab: int = 1 << 17, d_model: int = 256,
                       w: int = 16, n_leaves: int = 4096,
                       r_candidates: int = 128, nbr: int = 8,
                       q_batch: int = 32,
                       device: str | torch.device = "cuda"):
    """The ``KnnSoftmaxHead`` retrieval program: the extended search at
    serving widths, the MIPS series padded to a multiple of ``w`` as
    ``KnnSoftmaxHead`` pads it."""
    length = d_model + 1 + ((-(d_model + 1)) % w)
    return lower_search_extended(mesh, n_series=vocab, length=length, w=w,
                                 chunk=min(8192, vocab), n_leaves=n_leaves,
                                 k=r_candidates, nbr=nbr, q_batch=q_batch,
                                 device=device)


def dryrun_cells(mesh, device: str | torch.device = "cuda") -> dict:
    """The paper's own technique on ``mesh`` at the reference's 1 M × 256
    stand-in: each cell's :class:`~repro_torch.distributed.op_cost.OpCost`."""
    n_series, length, w, L = 1 << 20, 256, 16, 4096
    kw = dict(n_series=n_series, length=length, w=w, device=device)
    programs = {
        "dumpy_build": lower_build_step(mesh, **kw),
        "dumpy_build_bottomup": lower_build_bottomup(
            mesh, n_series=n_series, w=w, device=device),
        "dumpy_search": lower_search_oneshot(mesh, n_leaves=L, k=50, **kw),
        "dumpy_search_sharded": lower_search_sharded(mesh, chunk=4096,
                                                     n_leaves=L, **kw),
        "dumpy_search_extended": lower_search_extended(mesh, chunk=4096,
                                                       n_leaves=L, **kw),
        "dumpy_search_dtw": lower_search_dtw(mesh, n_leaves=L, **kw),
        "dumpy_search_approx": lower_search_approx(mesh, chunk=4096,
                                                   n_leaves=L, **kw),
        "dumpy_serving_head": lower_serving_head(mesh, device=device),
    }
    return {name: p.analyze() for name, p in programs.items()}
