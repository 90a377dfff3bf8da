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
``search_step`` are the reference's one-shot device programs.  The
reference's ``_abstract_prep``, ``lower_*`` and ``dryrun_cells`` lower XLA
programs for its TPU dry-run and have no counterpart here.
"""
from __future__ import annotations

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

def encode_distributed(db: np.ndarray, w: int, b: int, mesh=None
                       ) -> tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """Stage 1 and the root histogram of :func:`build_distributed`: ``db``
    cut into ``mesh.size`` row shards, :func:`build_step` on each shard's
    device, the table gathered to the host and the histograms summed on
    the mesh's first device.  Returns ``(paa [N, w] f32, sax [N, w] u8,
    hist [2**w] on mesh.devices[0])``.  Without ``mesh`` and a current
    mesh, one shard on the current CUDA device (raises without CUDA)."""
    if mesh is None:
        mesh = get_mesh() or make_mesh(["cuda"])
    db = np.ascontiguousarray(db, np.float32)
    N = db.shape[0]
    cuts = [s * N // mesh.size for s in range(mesh.size + 1)]
    home = mesh.devices[0]
    paa, sax, hist = [], [], None
    for s, d in enumerate(mesh.devices):
        x = torch.from_numpy(db[cuts[s]:cuts[s + 1]]).to(d)
        p, q, h = build_step(x, w, b)
        paa.append(p.cpu().numpy())  # lint: allow-sync: the table's gather
        sax.append(q.cpu().numpy().astype(np.uint8))  # lint: allow-sync: ditto
        h = h.to(home)
        hist = h if hist is None else hist + h          # the all-reduce
    return np.concatenate(paa), np.concatenate(sax), hist


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
