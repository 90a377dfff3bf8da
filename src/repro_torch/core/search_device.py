"""Device-resident exact kNN over a :class:`~repro_torch.core.device_index.
DeviceIndex` — the ED part of ``repro.core.search_device``.

Per shard of the ``[S, Tp, n]`` layout, the same plan as the reference:

    lb        = MINDIST(PAA(q), every local leaf)       (lb_paa_interval kernel)
    span LB   = segment-min over intersecting leaves    (scatter_reduce "amin")
    order     = stable argsort(min-over-queries span LB)
    while any query still has an unpruned span:
        slab  = shard rows [start, start + chunk)       (a view, no copy)
        d     = |q - slab|²                             (pairwise_l2 kernel)
        topk  = merge(topk, d)                          (per-query active mask)

then the per-shard top-k lists merge with an in-merge fuzzy-duplicate dedup,
and a k-sized host re-rank restores bitwise id/distance parity with the
host ``search.exact_search``.  Shards run one after another on one device;
each shard's early termination uses its local kth-best bound (≥ the global
bound), so every shard's local top-k is a superset of its contribution to
the global top-k, and the merged result does not depend on the shard count.

The reference's ``lax.while_loop`` tests its stop condition on every span;
in eager PyTorch that test is a host sync.  Here the span schedule reaches
the host once per shard, and the stop condition is tested once every
:data:`STOP_CHECK_EVERY` spans.  That is exact: once no query can improve
(``suffix LB ≥ kth best`` for all), every later span has ``qact`` all false,
so it merges only ``+inf / -1`` slots (the merged value set is unchanged)
and adds 0 to ``spans_visited``.

DTW (``metric="dtw"``) arrives with the DTW slice and raises until then.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from ..robustness.failpoints import failpoint, with_retries
from .device_index import DeviceIndex
from .index import DumpyIndex
from .metric import ED, Metric, dtw_not_ported, query_prep, resolve

#: spans between two host-side stop tests of the span loop (one sync each)
STOP_CHECK_EVERY = 16

_INF = float("inf")


# ---------------------------------------------------------------------------
# shared device helpers
# ---------------------------------------------------------------------------

def _prep_batch(metric: Metric, qs_dev: torch.Tensor, w: int, b: int
                ) -> tuple[tuple, torch.Tensor]:
    """Encode (``ops.sax_encode``: the kernel for a CUDA tensor, its twin
    for a CPU tensor) + metric-preprocess a query batch → ``(prep, sax_q)``
    with ``prep = (seg_lo, seg_hi, env_lo, env_hi)`` (see ``core.metric``)."""
    paa_q, sax_q = ops.sax_encode(qs_dev, w, b)
    return query_prep(metric, qs_dev, paa_q), sax_q.to(torch.int32)


def _dist2_slab(metric: Metric, qs: torch.Tensor, prep: tuple,
                slab: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Squared ED of the whole query batch against a shared candidate slab
    (the ``pairwise_l2`` kernel), invalid/pruned entries ``+inf``."""
    if metric.is_dtw:
        raise dtw_not_ported()
    return torch.where(valid, ops.pairwise_l2(qs, slab), _INF)


def _validate_queries_struct(qs, n: int) -> np.ndarray:
    """Structural half of :func:`_validate_queries` — dtype/shape/length,
    everything except the O(Q·n) finite scan."""
    qs = np.asarray(qs)
    if qs.dtype.kind not in "fiu":
        raise TypeError(
            f"queries must be real-numeric, got dtype {qs.dtype}")
    qs = np.atleast_2d(qs)
    if qs.ndim != 2:
        raise ValueError(
            f"queries must be [Q, n] (or [n]), got shape {qs.shape}")
    if qs.shape[1] != n:
        raise ValueError(
            f"query length {qs.shape[1]} != indexed series length {n}")
    return np.ascontiguousarray(qs, np.float32)


def lane_finite_mask(qs: np.ndarray) -> np.ndarray:
    """Vectorized NaN/Inf check over a batch: ``True`` where the lane is
    bad."""
    return ~np.isfinite(qs).all(axis=1)


def _validate_queries(qs, n: int) -> np.ndarray:
    """Host-boundary query validation: a NaN/Inf query would silently poison
    every distance it touches, and a wrong-length batch would broadcast into
    nonsense.  Returns the batch as contiguous ``[Q, n] float32``."""
    qs = _validate_queries_struct(qs, n)
    bad = np.where(lane_finite_mask(qs))[0]
    if bad.size:
        raise ValueError(
            f"queries {bad[:8].tolist()} contain NaN/Inf values")
    return qs


def _mask_dead_shards(health, topd: torch.Tensor, topi: torch.Tensor,
                      vis: torch.Tensor):
    """Degraded mode: erase dead shards' per-shard locals (``[S, Q, k]``)
    before the merge — their slots become ``+inf / -1``, which the dedup
    top-k treats as absent.  ``health`` is ``DeviceIndex.shard_health``;
    ``None`` (all healthy) is the identity."""
    if health is None:
        return topd, topi, vis
    m = torch.tensor(health, dtype=torch.bool, device=topd.device)
    topd = torch.where(m[:, None, None], topd, _INF)
    topi = torch.where(m[:, None, None], topi, -1)
    vis = torch.where(m[:, None], vis, 0)
    return topd, topi, vis


def shard_coverage(index: DumpyIndex, dev: DeviceIndex) -> float:
    """Fraction of distinct *live* series reachable through the surviving
    shards (1.0 when every shard is healthy)."""
    if dev.shard_health is None:
        return 1.0
    order = np.asarray(index.flat.order)
    alive = np.asarray(index.alive, bool)
    reach = np.zeros(alive.shape[0], bool)
    rb = dev.row_bounds
    for s, healthy in enumerate(dev.shard_health):
        if healthy:
            reach[order[rb[s]:rb[s + 1]]] = True
    total = int(alive.sum())
    if total == 0:
        return 1.0
    return float((reach & alive).sum()) / total


def _result_margin(dev: DeviceIndex, k: int) -> int:
    """Top-k width the device loop must carry: fuzzy duplication can fill up
    to ``1 + max_replica`` slots per distinct id."""
    if dev.has_duplicates:
        return k * (1 + dev.max_replica)
    return k


def _dedup_topk(d2: torch.Tensor, ids: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Device dedup + final top-k: segment-min over original ids.

    Each row is sorted by (id, d²) — two stable sorts, by d² then by id,
    are the reference's ``lexsort`` — so the first slot of an id run is that
    id's min distance; later slots (fuzzy replicas) and ``-1`` sentinels are
    masked to ``+inf``.  A stable sort by distance then keeps the smallest
    id among equal distances (the host heap's (d, id) order).  The output
    depends only on the (id, d²) value set, not on the shard count."""
    Q, C = ids.shape
    p = torch.sort(d2, dim=1, stable=True).indices
    ids1, d1 = torch.gather(ids, 1, p), torch.gather(d2, 1, p)
    p = torch.sort(ids1, dim=1, stable=True).indices
    ids_s, d_s = torch.gather(ids1, 1, p), torch.gather(d1, 1, p)
    first = torch.ones_like(ids_s, dtype=torch.bool)
    first[:, 1:] = ids_s[:, 1:] != ids_s[:, :-1]
    keep = first & (ids_s >= 0)
    d_m = torch.where(keep, d_s, _INF)
    i_m = torch.where(keep, ids_s, -1)
    sel = torch.sort(d_m, dim=1, stable=True).indices[:, :min(k, C)]
    return torch.gather(d_m, 1, sel), torch.gather(i_m, 1, sel)


# ---------------------------------------------------------------------------
# sharded exact search (S=1 is the single-shard case)
# ---------------------------------------------------------------------------

def _shard_knn(dev: DeviceIndex, s: int, prep: tuple, qs: torch.Tensor,
               k: int, metric: Metric
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """One shard's span loop → ``(topd [Q,k], topi [Q,k], vis [Q], syncs)``."""
    Q = qs.shape[0]
    chunk, n = dev.chunk, dev.n
    device = qs.device
    db_s, alive_s, ids_s = dev.db[s], dev.alive[s], dev.ids[s]
    W = dev.win_start.shape[1]
    lbq = ops.lb_paa_interval(prep[0], prep[1], dev.leaf_lo[s],
                              dev.leaf_hi[s], n)                 # [Q, Lp] sq
    # span LB = min over intersecting leaves (exact: it lower-bounds every
    # series the span contains; pad edges hit the +inf pad leaf)
    e_leaf = dev.edge_leaf[s].long()
    e_win = dev.edge_win[s].long()
    win_lb = torch.full((Q, W), _INF, dtype=torch.float32, device=device)
    win_lb = win_lb.scatter_reduce(1, e_win[None, :].expand(Q, -1),
                                   lbq[:, e_leaf], "amin", include_self=False)
    order = torch.argsort(win_lb.min(dim=0).values, stable=True)
    win_lb = win_lb[:, order]
    suffix = torch.flip(torch.cummin(torch.flip(win_lb, [1]), dim=1).values,
                        [1])
    # the sorted span schedule goes to the host once per shard (one sync)
    sched = torch.stack([dev.win_start[s], dev.win_lead[s],
                         dev.win_size[s]])[:, order].cpu().numpy()
    syncs = 1

    topd = torch.full((Q, k), _INF, dtype=torch.float32, device=device)
    topi = torch.full((Q, k), -1, dtype=torch.int32, device=device)
    vis = torch.zeros(Q, dtype=torch.int32, device=device)
    for i in range(W):
        if i % STOP_CHECK_EVERY == 0:
            syncs += 1
            if not bool((suffix[:, i] < topd[:, k - 1]).any()):
                break
        start, lead, size = (int(v) for v in sched[:, i])
        qact = win_lb[:, i] < topd[:, k - 1]                    # [Q] active
        valid = torch.zeros(chunk, dtype=torch.bool, device=device)
        valid[lead:lead + size] = alive_s[start + lead:start + lead + size]
        d2 = _dist2_slab(metric, qs, prep, db_s[start:start + chunk],
                         valid[None, :] & qact[:, None])
        sid = ids_s[start:start + chunk]
        idt = torch.where(torch.isinf(d2), -1, sid[None, :].expand(Q, -1))
        topd, topi = ops.topk_merge(topd, topi, d2, idt)
        vis += qact.to(torch.int32)
    return topd, topi, vis, syncs


def _exact_knn_sharded(dev: DeviceIndex, prep: tuple, qs: torch.Tensor, *,
                       k: int, metric: Metric = ED
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  int]:
    """Interval-MINDIST tables → per-shard span loops → merge with in-merge
    dedup.  Returns ``(d [Q,k], original ids [Q,k], spans_visited [Q],
    host syncs)`` with invalid slots as ``inf / -1``.

    Early termination is per query *and* per shard: along the shard's span
    order, query q may stop merging at step i iff its suffix-min LB there is
    ≥ its running kth best — every span it has not seen locally is
    individually prunable."""
    Q = qs.shape[0]
    parts = [_shard_knn(dev, s, prep, qs, k, metric)
             for s in range(dev.n_shards)]
    topd = torch.stack([p[0] for p in parts])                    # [S, Q, k]
    topi = torch.stack([p[1] for p in parts])
    vis = torch.stack([p[2] for p in parts])
    topd, topi, vis = _mask_dead_shards(dev.shard_health, topd, topi, vis)
    S = topd.shape[0]
    alld = topd.permute(1, 0, 2).reshape(Q, S * k)
    alli = topi.permute(1, 0, 2).reshape(Q, S * k)
    d2m, idm = _dedup_topk(alld, alli, k)
    return torch.sqrt(d2m), idm, vis.sum(dim=0), sum(p[3] for p in parts)


def _finalize_exact(index: DumpyIndex, qs: np.ndarray, ids_dev: np.ndarray,
                    k: int) -> tuple[np.ndarray, np.ndarray]:
    """k-sized host re-rank for bitwise parity with ``search.exact_search``:
    recompute candidate distances with the host math (direct-difference ED)
    and sort by (d, id) — exactly the host heap's order.  This is also what
    makes the result independent of ``torch.topk``'s order among equal
    device distances.  Device invalid slots (``id -1``) stay padded as
    ``-1 / inf``."""
    Q, kk = ids_dev.shape
    if index.db.shape[0] == 0:                              # empty collection
        return (np.full((Q, k), -1, np.int64),
                np.full((Q, k), np.inf, np.float32))
    cand = index.db[np.maximum(ids_dev, 0)]                 # [Q, kk, n]
    diff = cand - qs[:, None, :]
    d = np.sqrt((diff * diff).sum(axis=-1)).astype(np.float32)
    d = np.where(ids_dev < 0, np.inf, d)
    out_ids = np.full((Q, k), -1, np.int64)
    out_d = np.full((Q, k), np.inf, np.float32)
    for qi in range(Q):
        perm = np.lexsort((ids_dev[qi], d[qi]))[:k]
        perm = perm[np.isfinite(d[qi][perm])]
        out_ids[qi, :len(perm)] = ids_dev[qi][perm]
        out_d[qi, :len(perm)] = d[qi][perm]
    return out_ids, out_d


def exact_search_device_batch(index: DumpyIndex, qs: np.ndarray, k: int,
                              chunk: int = 2048, n_shards: int = 1,
                              dev: DeviceIndex | None = None,
                              metric: str | Metric = "ed",
                              band: int | None = None,
                              order: str | None = None,
                              return_stats: bool = False,
                              shard_health=None,
                              device: str | torch.device = "cuda"):
    """Batched exact kNN: ``qs [Q, n]`` → ``(ids [Q, k], d [Q, k],
    spans_visited [Q])``.  Results match ``search.exact_search`` per query
    (fuzzy duplicates deduplicated on device, tombstones skipped,
    ``k > n_alive`` truncates); short results pad with ``id -1 / d inf``.

    Runs on ``device`` (CUDA unless the caller asks for ``"cpu"``; raises
    where CUDA is absent), or on the device of a given ``dev``.
    ``n_shards`` picks the ``[S, ...]`` layout of the cached
    ``DeviceIndex``; the result is bitwise the same for every shard count.
    ``shard_health`` (a length-``n_shards`` bool sequence, or a ``dev``
    whose ``shard_health`` is set) enables degraded mode: dead shards are
    masked out of the merge and the return tuple gains a trailing
    ``coverage`` float.  ``return_stats=True`` appends
    ``{"host_syncs": …}``, the number of device→host syncs of the span
    loops."""
    qs = _validate_queries(qs, index.n)
    met = resolve(metric, qs.shape[1], band, order)
    if met.is_dtw:
        raise dtw_not_ported()
    if dev is None:
        dev = index.device_index(chunk=chunk, n_shards=n_shards,
                                 device=device)
    want_cov = shard_health is not None or dev.shard_health is not None
    if shard_health is not None:
        dev = dev.with_shard_health(shard_health)
    sax = index.params.sax
    qs_dev = torch.from_numpy(qs).to(dev.device)
    prep, _ = _prep_batch(met, qs_dev, sax.w, sax.b)
    # +8 slack: the loop ranks by the f32 |q|²+|x|²-2qx form whose rounding
    # can swap near-ties across the k boundary; the host re-rank then picks
    # the true top-k from the widened set
    kk = _result_margin(dev, k) + 8

    def _launch():
        failpoint("search.shard_merge")
        return _exact_knn_sharded(dev, prep, qs_dev, k=kk, metric=met)

    _, ids, visited, syncs = with_retries(_launch, site="search.shard_merge")
    ids_out, d_out = _finalize_exact(index, qs, ids.cpu().numpy(), k)
    out = [ids_out, d_out, visited.cpu().numpy()]
    if want_cov:
        out.append(shard_coverage(index, dev))
    if return_stats:
        out.append({"host_syncs": syncs})
    return tuple(out)


def exact_search_device(index: DumpyIndex, q: np.ndarray, k: int,
                        chunk: int = 2048, metric: str | Metric = "ed",
                        band: int | None = None,
                        device: str | torch.device = "cuda"
                        ) -> tuple[np.ndarray, np.ndarray, int]:
    """Single-query exact kNN: a batch of one through the shared device
    path.  Returns (original ids, distances, spans visited)."""
    ids, d, visited = exact_search_device_batch(index, q.reshape(1, -1), k,
                                                chunk=chunk, metric=metric,
                                                band=band, device=device)
    valid = ids[0] >= 0
    return ids[0][valid], d[0][valid], int(visited[0])
