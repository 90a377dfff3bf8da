"""Device-resident kNN over a :class:`~repro_torch.core.device_index.
DeviceIndex` — the exact, approximate and extended searches of
``repro.core.search_device``, for ED and banded DTW.

Per shard of the ``[S, Tp, n]`` layout, the same plan as the reference:

    lb        = MINDIST(interval(q), every local leaf)  (lb_paa_interval kernel)
    span LB   = segment-min over intersecting leaves    (scatter_reduce "amin")
    order     = stable argsort(min-over-queries span LB)
    while any query still has an unpruned span:
        slab  = shard rows [start, start + chunk)       (a view, no copy)
        d     = |q - slab|²  or the DTW cascade         (kernels, see below)
        topk  = merge(topk, d)                          (per-query active mask)

then the per-shard top-k lists merge with an in-merge fuzzy-duplicate dedup,
and a k-sized host re-rank (direct-difference ED, or the float64 ``dtw_np``
DP) restores bitwise id/distance parity with the host ``search.exact_search``.
One host thread drives every shard's loop at once (:func:`_drive`), on one
device or, on a mesh (``DeviceIndex.shard``), each on its own device with
its own copy of the queries, their shard-local results moved to the mesh's
first device for the merge (the all-gather).  Each shard's early
termination uses its local kth-best bound (≥ the global bound), so the
merged result does not depend on the shard count or the placement.

DTW (``metric="dtw"``) shares the ED layout.  Its candidate distance is the
cascade LB_Keogh → LB_Improved → masked banded DP (the ``lb_keogh``,
``lb_improved`` and ``dtw_band`` kernels); each stage masks the next against
the running k-th best, and per-stage kill counters come back with
``return_stats``.  ``Metric.order`` picks the candidate order:

- ``"shared"`` — the span loop above, each slab cut into ``DTW_SUB``-row
  sub-slabs with the cutoff re-read before each;
- ``"perq"`` — LB tables over every lane, each query's lanes sorted by its
  own LB_Improved, a DP over its first ``k`` lanes seeding the cutoff, then
  ``DTW_LANE_CHUNK``-wide gather chunks of its sorted lanes until its next
  LB reaches its cutoff;
- ``"cluster"`` — ``"perq"`` with the queries grouped by estimated work,
  one walk per group (bitwise the ``"perq"`` result).

The reference's ``lax.while_loop`` tests its stop condition on the device
every step; in eager PyTorch that test is a host sync.  Both loops here
reach the host once every :data:`STOP_CHECK_EVERY` steps.  That is exact:
in the span loop, once no query can improve (``suffix LB ≥ kth best`` for
all), every later span has ``qact`` all false, so it merges only ``+inf /
-1`` slots and adds 0 to ``spans_visited`` and to every counter; the lane
walk carries the reference's condition as a device-side flag that, once
false, masks every later step's lanes (nothing merged, nothing counted).

Approximate search (paper §5.5) routes the whole batch root→leaf in
lockstep over the flattened routing tables (``dev.depth`` steps, no host
sync) and scans the routed leaf plus the ``nbr-1`` next-best leaves by the
leaf bound, one rank at a time over the flattened ``[S·Tp, n]`` view.
Extended search (paper Alg. 4) descends only to the smallest subtree
within the ``nbr`` leaf budget, builds each query's visit schedule from the
sibling tables (target subtree first, the other siblings by lower bound,
leaves by lower bound within each), and scans it shard by shard before the
same dedup merge.  Both scan per-query leaf gathers ``[Q, lmax, n]``
(:func:`_dist2_gather`: the direct-difference ED sum, or the DTW cascade
kernels in their per-query layout).  Where the reference relies on JAX's
order among equal keys (``lax.top_k``, ``lexsort``, ``argsort``), the port
sorts stably.

The serving buckets (``bucket_search_*``) run extended search with every
per-request knob as a lane array: a per-lane leaf budget (0 marks a dead
lane), a per-lane metric, and per-lane ``k`` applied on the host.  Lane q
of a bucket is bitwise the request issued alone.  The launch queues the
whole bucket without waiting for the device, so a front-end stages the
next bucket while this one computes.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ..kernels import ops
from ..robustness.failpoints import failpoint, with_retries
from .device_index import DeviceIndex
from .index import DumpyIndex
from .lb import dtw_np_batch, sum_last_fixed
from .metric import ED, Metric, default_band, query_prep, resolve

#: steps between two host-side stop tests of the span loop and of the DTW
#: lane walk (one sync each)
STOP_CHECK_EVERY = 16
#: DTW sub-block width inside a span slab (bounds the DP's lane count per
#: launch without a second, narrower layout)
DTW_SUB = 256
#: gather-chunk width of the per-query lane-ordered DTW programs
DTW_LANE_CHUNK = 128
#: lane-chunk width of the LB table precompute of those programs
DTW_LB_CHUNK = 2048

#: slots of the per-stage cascade counters; ``dp_survivors = considered -
#: killed_lb_keogh - killed_lb_improved - dp_abandoned`` is derived at the end
STAT_KEYS = ("considered", "killed_lb_keogh", "killed_lb_improved",
             "dp_abandoned")

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


def _to_device(tree, device: torch.device):
    """A tensor, or a nested tuple of tensors and ``None``, on ``device``."""
    if isinstance(tree, tuple):
        return tuple(_to_device(t, device) for t in tree)
    return None if tree is None else tree.to(device)


def _replicator(tree, home: torch.device):
    """``on(device)`` → ``tree`` on ``device``, copied once a device: the
    query side of a search replicated over the devices of a mesh (``home``
    holds the original)."""
    copies = {torch.device(home): tree}

    def on(device: torch.device):
        if device not in copies:
            copies[device] = _to_device(tree, device)
        return copies[device]

    return on


def _cascade_stats(valid: torch.Tensor, lbk2: torch.Tensor,
                   lbi2: torch.Tensor, d2: torch.Tensor,
                   cutoff2: torch.Tensor) -> torch.Tensor:
    """Per-stage kill counters of one cascade invocation → int64[4]
    (:data:`STAT_KEYS` order), on the device.  ``valid`` are the lanes the
    cascade looked at; a lane that ran the DP but came back ``+inf`` was
    cutoff-abandoned mid-DP."""
    ct = cutoff2[:, None]
    k1 = valid & (lbk2 >= ct)
    k2 = valid & (lbk2 < ct) & (lbi2 >= ct)
    ran = valid & (lbi2 < ct)
    ab = ran & torch.isinf(d2)
    return torch.stack([valid.sum(), k1.sum(), k2.sum(), ab.sum()])


def _dist2_slab(metric: Metric, qs: torch.Tensor, prep: tuple,
                slab: torch.Tensor, valid: torch.Tensor,
                cutoff2: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Squared distances of the whole query batch against a shared
    candidate slab, invalid/pruned entries ``+inf`` → ``(d2 [Q, m], stats
    int64[4] or None for ED)``.  ED is the ``pairwise_l2`` kernel; DTW runs
    the cascade — LB_Keogh, then LB_Improved, and only lanes both leave
    below the running cutoff ``cutoff2 [Q]`` pay the masked band DP."""
    if not metric.is_dtw:
        return torch.where(valid, ops.pairwise_l2(qs, slab), _INF), None
    _, _, env_lo, env_hi = prep
    lbk2 = ops.lb_keogh(slab, env_hi, env_lo)                  # [Q, m]
    lbi2 = ops.lb_improved(slab, qs, env_hi, env_lo, metric.band)
    ct = cutoff2[:, None]
    mask = valid & (lbk2 < ct) & (lbi2 < ct)
    d2 = ops.dtw_band(qs, slab, mask, cutoff2, metric.band)
    return d2, _cascade_stats(valid, lbk2, lbi2, d2, cutoff2)


def _dist2_gather(metric: Metric, qs: torch.Tensor, prep: tuple,
                  cand: torch.Tensor, valid: torch.Tensor,
                  cutoff2: torch.Tensor) -> torch.Tensor:
    """As :func:`_dist2_slab` but with *per-query* candidate sets
    ``cand [Q, m, n]`` (the leaf-gather layout of the approximate and
    extended scans); returns just ``d2 [Q, m]`` — the gather callers keep
    no counters.  ED is the direct-difference sum (the reference computes
    it outside any kernel); DTW runs the cascade with the ``lb_keogh``,
    ``lb_improved`` and ``dtw_band`` kernels in their per-query layout.
    Masking a lane whose LB reaches the cutoff never changes a merge
    result (it could not displace a held slot)."""
    if not metric.is_dtw:
        diff = cand - qs[:, None, :]
        return torch.where(valid, diff.square_().sum(-1), _INF)
    _, _, env_lo, env_hi = prep
    lbk2 = ops.lb_keogh(cand, env_hi, env_lo)                  # [Q, m]
    lbi2 = ops.lb_improved(cand, qs, env_hi, env_lo, metric.band)
    ct = cutoff2[:, None]
    mask = valid & (lbk2 < ct) & (lbi2 < ct)
    return ops.dtw_band(qs, cand, mask, cutoff2, metric.band)


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


def lane_finite_error() -> ValueError:
    """The exact exception :func:`_validate_queries` raises for a bad batch
    of one — what an offending request would have seen had it been issued
    on its own rather than coalesced with others."""
    return ValueError("queries [0] contain NaN/Inf values")


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


def _mask_dead_shards(dev: DeviceIndex, topd: torch.Tensor,
                      topi: torch.Tensor, vis: torch.Tensor | None = None,
                      st: torch.Tensor | None = None):
    """Degraded mode: erase dead shards' per-shard locals (``[S, Q, k]``,
    ``vis [S, Q]``, cascade counters ``st [S, 4]``; the last two optional)
    before the merge — their slots become ``+inf / -1``, which the dedup
    top-k treats as absent.  All shards healthy (``dev.shard_health`` is
    ``None``) is the identity."""
    m = dev.health_mask
    if m is None:
        return topd, topi, vis, st
    topd = torch.where(m[:, None, None], topd, _INF)
    topi = torch.where(m[:, None, None], topi, -1)
    if vis is not None:
        vis = torch.where(m[:, None], vis, 0)
    if st is not None:
        st = torch.where(m[:, None], st, 0)
    return topd, topi, vis, st


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


def _lexsort2(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """Row-wise ``jnp.lexsort((minor, major), axis=-1)``: the permutation
    that sorts each row by ``major``, then ``minor``, then position — two
    stable sorts, the least significant key first."""
    p = torch.sort(minor, dim=1, stable=True).indices
    q = torch.sort(torch.gather(major, 1, p), dim=1, stable=True).indices
    return torch.gather(p, 1, q)


def _dedup_topk(d2: torch.Tensor, ids: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Device dedup + final top-k: segment-min over original ids.

    Each row is sorted by (id, d²) (:func:`_lexsort2`, the reference's
    ``lexsort``), so the first slot of an id run is that id's min distance;
    later slots (fuzzy replicas) and ``-1`` sentinels are masked to
    ``+inf``.  A stable sort by distance then keeps the smallest id among
    equal distances (the host heap's (d, id) order).  The output depends
    only on the (id, d²) value set, not on the shard count."""
    Q, C = ids.shape
    perm = _lexsort2(d2, ids)
    ids_s, d_s = torch.gather(ids, 1, perm), torch.gather(d2, 1, perm)
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

def _span_prologue(dev: DeviceIndex, s: int, prep: tuple, qs: torch.Tensor,
                   metric: Metric):
    """The span loop's set-up on shard ``s`` → ``(slabs, n_sub, win_lb,
    suffix, order)``: the shard's ``(db, alive, ids)``, the sub-slabs a
    span, each query's span LB ``win_lb [Q, W]`` in the span order (stable
    ascending min over the queries) and its suffix min."""
    Q = qs.shape[0]
    chunk, n = dev.chunk, dev.n
    device = qs.device
    slabs = dev.db[s], dev.alive[s], dev.ids[s]
    W = dev.win_start[s].shape[0]
    # sub-blocking needs exact tiling; an odd explicit chunk (or one
    # already at/below DTW_SUB) runs the slab whole, as the reference does
    n_sub = chunk // DTW_SUB if (
        metric.is_dtw and chunk > DTW_SUB and chunk % DTW_SUB == 0) else 1
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
    return slabs, n_sub, win_lb, suffix, order


def _span_carry(Q: int, k: int, device: torch.device) -> tuple:
    """The span loop's first carry: ``(topd [Q, k] +inf, topi [Q, k] -1,
    vis [Q] 0, stats int64[4] 0)``."""
    return (torch.full((Q, k), _INF, dtype=torch.float32, device=device),
            torch.full((Q, k), -1, dtype=torch.int32, device=device),
            torch.zeros(Q, dtype=torch.int32, device=device),
            torch.zeros(4, dtype=torch.int64, device=device))


def _span_step(metric: Metric, qs: torch.Tensor, prep: tuple, slabs: tuple,
               win_lb: torch.Tensor, chunk: int, n_sub: int, carry: tuple,
               i: int, start: int, lead: int, size: int) -> tuple:
    """One span of the loop → the next carry: the ``chunk`` rows from
    ``start`` (live ``[lead, lead + size)``) at rank ``i`` of the span
    order, in ``n_sub`` sub-slabs through :func:`_dist2_slab` and the top-k
    merge.  DTW re-reads the running cutoff before each sub-slab after the
    first, so later sub-slabs prune against what earlier ones merged.
    ``i``, ``start``, ``lead`` and ``size`` are host ints: every span has
    the same shapes."""
    topd, topi, vis, st = carry
    db_s, alive_s, ids_s = slabs
    Q, k = topd.shape
    device = qs.device
    sub_w = chunk // n_sub
    qact = win_lb[:, i] < topd[:, k - 1]                    # [Q] active
    valid = torch.zeros(chunk, dtype=torch.bool, device=device)
    valid[lead:lead + size] = alive_s[start + lead:start + lead + size]
    for b in range(n_sub):
        s0 = start + b * sub_w
        # the cutoff re-read of every sub-slab after the first
        qact_b = qact if b == 0 else qact & (win_lb[:, i] < topd[:, k - 1])
        d2, stt = _dist2_slab(
            metric, qs, prep, db_s[s0:s0 + sub_w],
            valid[None, b * sub_w:(b + 1) * sub_w] & qact_b[:, None],
            topd[:, k - 1].contiguous())
        sid = ids_s[s0:s0 + sub_w]
        idt = torch.where(torch.isinf(d2), -1, sid[None, :].expand(Q, -1))
        topd, topi = ops.topk_merge(topd, topi, d2, idt)
        if stt is not None:
            st += stt
    vis += qact.to(torch.int32)
    return topd, topi, vis, st


def _shard_knn(dev: DeviceIndex, s: int, prep: tuple, qs: torch.Tensor,
               k: int, metric: Metric):
    """One shard's span loop, as a loop :func:`_drive` runs → ``(topd
    [Q,k], topi [Q,k], vis [Q], stats int64[4])``: :func:`_span_prologue`,
    then :func:`_span_step` over the sorted span schedule, which goes to
    the host once, until the stop test (every :data:`STOP_CHECK_EVERY`
    spans) finds no query that can still improve.  It yields before each
    of those host reads."""
    slabs, n_sub, win_lb, suffix, order = _span_prologue(dev, s, prep, qs,
                                                         metric)
    # the sorted span schedule goes to the host once per shard (one read)
    yield
    sched = torch.stack([dev.win_start[s], dev.win_lead[s],
                         dev.win_size[s]])[:, order].cpu().numpy()

    carry = _span_carry(qs.shape[0], k, qs.device)
    for i in range(win_lb.shape[1]):
        if i % STOP_CHECK_EVERY == 0:
            yield
            if not bool((suffix[:, i] < carry[0][:, k - 1]).any()):  # lint: allow-sync: the stop test
                break
        start, lead, size = (int(v) for v in sched[:, i])  # lint: allow-sync: host array
        carry = _span_step(metric, qs, prep, slabs, win_lb, dev.chunk, n_sub,
                           carry, i, start, lead, size)
    return carry


def _current(device: torch.device):
    """A block with ``device`` the current card (nothing for the CPU): the
    ops of one shard's step then find their card current and switch none."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _drive(loops: list, devices: list | None = None) -> tuple[list, list]:
    """Run the shards' loops at once from one host thread → ``(their
    results, their host reads)``, one entry a loop, in order.  Loop ``i``
    runs with ``devices[i]`` current, where given.

    A loop (:func:`_shard_knn`, :func:`_lane_knn`) is a generator that
    queues its shard's device work and yields just before each read of the
    device (the span schedule, a stop test).  Every loop first queues its
    set-up; then it resumes the loops in turn, each through one
    read and up to its next yield: one block of ``STOP_CHECK_EVERY`` steps.
    A read waits for its own shard's device alone, so while the host waits
    on one card, the others run the blocks already queued on them, as the
    reference's shard-local loops run on every device at once.  A loop
    whose stop test fires returns and gets no further step.  Each loop
    makes the same reads, steps and stop decisions as it would alone, so
    its result does not depend on the others, nor its reads."""
    results = [None] * len(loops)
    reads = [0] * len(loops)
    cpu = torch.device("cpu")

    def advance(i, loop, running):
        try:
            with _current(devices[i] if devices else cpu):
                next(loop)
        except StopIteration as stop:
            results[i] = stop.value
        else:
            running.append((i, loop))

    running = []
    for i, loop in enumerate(loops):
        advance(i, loop, running)
    while running:
        now, running = running, []
        for i, loop in now:
            reads[i] += 1
            advance(i, loop, running)
    return results, reads


def _exact_knn_sharded(dev: DeviceIndex, prep: tuple, qs: torch.Tensor, *,
                       k: int, metric: Metric = ED):
    """Per-shard searches → merge with in-merge dedup.  Returns ``(d [Q,k],
    original ids [Q,k], visited [Q], cascade stats int64[4], host syncs)``
    with invalid slots as ``inf / -1`` (stats all zero for ED).  Each shard
    runs the span loop (:func:`_shard_knn`; ED and the DTW ``"shared"``
    order) or the lane-ordered DTW program (:func:`_lane_knn`), all of
    them at once under :func:`_drive`.

    On a mesh each shard runs on its own device with its own copy of the
    queries and their prep, and its ``[Q, k]`` locals move to ``dev.device``
    before the merge (the reference's all-gather).

    Early termination is per query *and* per shard: each shard prunes
    against its local kth best (≥ the global one), so every shard's local
    top-k is a superset of its contribution to the global top-k."""
    Q = qs.shape[0]
    home = dev.device
    knn = _lane_knn if metric.is_dtw and metric.order != "shared" \
        else _shard_knn
    inputs = _replicator((prep, qs), home)
    devices = [dev.shard_device(s) for s in range(dev.n_shards)]
    parts, reads = _drive([knn(dev, s, *inputs(d), k, metric)
                           for s, d in enumerate(devices)], devices)
    parts = [_to_device(p, home) for p in parts]
    return _merge_shards(dev, parts, Q, k) + (sum(reads),)


def _merge_shards(dev: DeviceIndex, parts: list, Q: int, k: int) -> tuple:
    """The merge of the shards' ``(topd, topi, vis, stats)`` on one device:
    dead shards masked (:func:`_mask_dead_shards`), the ``[Q, S·k]`` lists
    deduplicated to the top ``k`` → ``(d [Q, k], ids [Q, k], visited [Q],
    stats int64[4])``."""
    topd = torch.stack([p[0] for p in parts])                    # [S, Q, k]
    topi = torch.stack([p[1] for p in parts])
    vis = torch.stack([p[2] for p in parts])
    st = torch.stack([p[3] for p in parts])
    topd, topi, vis, st = _mask_dead_shards(dev, topd, topi, vis, st)
    S = topd.shape[0]
    alld = topd.permute(1, 0, 2).reshape(Q, S * k)
    alli = topi.permute(1, 0, 2).reshape(Q, S * k)
    d2m, idm = _dedup_topk(alld, alli, k)
    return torch.sqrt(d2m), idm, vis.sum(dim=0), st.sum(dim=0)


def _cluster_groups(Q: int) -> int:
    """Sub-batch count of the ``"cluster"`` ordering: enough groups that
    stragglers stop holding the whole batch, few enough that each group's
    walk still amortizes its launches (the reference's rule)."""
    if Q % 4 == 0 and Q >= 32:
        return 4
    if Q % 2 == 0 and Q >= 16:
        return 2
    return 1


def _lane_walk(db_s: torch.Tensor, ids_s: torch.Tensor, qs: torch.Tensor,
               order: torch.Tensor, lbi_s: torch.Tensor, lbk_s: torch.Tensor,
               topd: torch.Tensor, topi: torch.Tensor, r: int, kseed: int):
    """Stage 4 of :func:`_lane_knn` for one group of queries, as a loop
    :func:`_drive` runs (it yields before each stop test): walk
    ``DTW_LANE_CHUNK``-wide chunks of every query's LB_Improved-sorted lanes
    (``order``, ``lbi_s``, ``lbk_s [Qg, Tp]``) from rank ``kseed`` on, each
    chunk's lanes masked against the re-read cutoff, while the smallest
    unvisited LB of some query is below its cutoff.  Returns ``(topd, topi,
    vis, stats int64[4])``; ``vis`` counts the chunks a query had a lane
    in, the seed chunk included.

    The reference tests that condition on the device before every chunk.
    Here it is a device-side flag ``running`` (sticky: once false, no lane
    is seen again, so the condition stays false) that gates every chunk's
    lanes, and the host reads it once every :data:`STOP_CHECK_EVERY`
    chunks: chunks run after it turned false see no lane, merge only
    ``+inf`` and count nothing."""
    C, NC, cols, carry = _walk_init(order, topd, topi, kseed)
    for c in range(NC):
        if c % STOP_CHECK_EVERY == 0:
            yield
            if not bool(carry[4]):  # lint: allow-sync: the stop test
                break
        carry = _walk_step(db_s, ids_s, qs, order, lbi_s, lbk_s, cols, r,
                           kseed, carry, c)
    return carry[:4]


def _walk_init(order: torch.Tensor, topd: torch.Tensor, topi: torch.Tensor,
               kseed: int) -> tuple:
    """The lane walk's set-up → ``(C, NC, cols, carry)``: the chunk width,
    the chunks from rank ``kseed`` to the last lane, the chunk's column
    numbers and the first carry ``(topd, topi, vis, stats, running)``."""
    Qg, Tp = order.shape
    device = order.device
    C = min(DTW_LANE_CHUNK, Tp)
    NC = max(-(-(Tp - kseed) // C), 0)
    cols = torch.arange(C, device=device)
    vis = torch.ones(Qg, dtype=torch.int32, device=device)
    st = torch.zeros(4, dtype=torch.int64, device=device)
    running = torch.ones((), dtype=torch.bool, device=device)
    return C, NC, cols, (topd, topi, vis, st, running)


def _walk_step(db_s: torch.Tensor, ids_s: torch.Tensor, qs: torch.Tensor,
               order: torch.Tensor, lbi_s: torch.Tensor, lbk_s: torch.Tensor,
               cols: torch.Tensor, r: int, kseed: int, carry: tuple,
               c: int) -> tuple:
    """Chunk ``c`` of the lane walk (ranks from ``kseed + c·C``; the last
    chunk ends at the last lane and masks the ranks an earlier chunk saw)
    → the next carry.  ``c`` is a host int: every chunk has the same
    shapes."""
    topd, topi, vis, st, running = carry
    Tp = order.shape[1]
    k = topd.shape[1]
    C = cols.shape[0]
    r0 = kseed + c * C
    cutoff = topd[:, k - 1].contiguous()
    running = running & (lbi_s[:, r0] < cutoff).any()
    s0 = min(r0, Tp - C)
    fresh = cols >= (r0 - s0)              # ranks < r0 already seen
    idx = order[:, s0:s0 + C].contiguous()
    lbi_c = lbi_s[:, s0:s0 + C]
    seen = fresh[None, :] & torch.isfinite(lbi_c) & running
    mask = seen & (lbi_c < cutoff[:, None])
    d2 = ops.dtw_band(qs, db_s, mask, cutoff, r, idx=idx)
    idt = torch.where(torch.isinf(d2), -1, ids_s[idx])
    topd, topi = ops.topk_merge(topd, topi, d2, idt)
    st += _cascade_stats(seen, lbk_s[:, s0:s0 + C], lbi_c, d2, cutoff)
    vis += mask.any(dim=1).to(torch.int32)
    return topd, topi, vis, st, running


def _lb_init(Q: int, Tp: int, device: torch.device) -> tuple:
    """Stage 1's tables ``(lbk_all, lbi_all)``, ``[Q, Tp]`` each, unset."""
    return (torch.empty((Q, Tp), dtype=torch.float32, device=device),
            torch.empty((Q, Tp), dtype=torch.float32, device=device))


def _lb_slab(db_s: torch.Tensor, alive_s: torch.Tensor, qs: torch.Tensor,
             env_lo: torch.Tensor, env_hi: torch.Tensor, r: int,
             tables: tuple, c: int) -> tuple:
    """Slab ``c`` of stage 1: LB_Keogh and LB_Improved of ``DTW_LB_CHUNK``
    lanes (the tail slab ends at the last lane and recomputes a few), dead
    lanes ``+inf``, written into ``tables`` in place.  ``c`` is a host int:
    every slab has the same shapes."""
    lbk_all, lbi_all = tables
    Tp = db_s.shape[0]
    LC = min(DTW_LB_CHUNK, Tp)
    s0 = min(c * LC, Tp - LC)        # the tail slab recomputes a few
    slab = db_s[s0:s0 + LC]
    al = alive_s[None, s0:s0 + LC]
    lbk_all[:, s0:s0 + LC] = torch.where(
        al, ops.lb_keogh(slab, env_hi, env_lo), _INF)
    lbi_all[:, s0:s0 + LC] = torch.where(
        al, ops.lb_improved(slab, qs, env_hi, env_lo, r), _INF)
    return tables


def _lb_trips(Tp: int) -> int:
    """Stage 1's slabs over ``Tp`` lanes: ⌈Tp / ``DTW_LB_CHUNK``⌉."""
    return -(-Tp // min(DTW_LB_CHUNK, Tp))


def _lb_tables(db_s: torch.Tensor, alive_s: torch.Tensor, qs: torch.Tensor,
               env_lo: torch.Tensor, env_hi: torch.Tensor, r: int) -> tuple:
    """Stage 1 of :func:`_lane_knn`: ``(lbk_all, lbi_all) [Q, Tp]`` over
    every lane, one :func:`_lb_slab` a ``DTW_LB_CHUNK``-lane slab."""
    Tp = db_s.shape[0]
    tables = _lb_init(qs.shape[0], Tp, qs.device)
    for c in range(_lb_trips(Tp)):
        tables = _lb_slab(db_s, alive_s, qs, env_lo, env_hi, r, tables, c)
    return tables


def _lane_knn(dev: DeviceIndex, s: int, prep: tuple, qs: torch.Tensor,
              k: int, metric: Metric, tables=None, walk=None):
    """One shard of the per-query-ordered DTW program (``Metric.order`` ∈
    {"perq", "cluster"}), as a loop :func:`_drive` runs → ``(topd, topi,
    vis, stats)``; ``vis`` counts the gather chunks a query was live for,
    the analogue of spans visited.

    (1) LB_Keogh and LB_Improved tables ``[Q, Tp]`` over every lane, in
    ``DTW_LB_CHUNK``-lane slabs (dead lanes ``+inf``); (2) each query's lanes
    stably sorted by its LB_Improved; (3) a DP over each query's first
    ``k`` lanes seeds the running top-k; (4) :func:`_lane_walk` over the
    sorted ranks.  Because each query's lanes arrive ascending by LB, every
    unvisited lane has ``LB_Improved ≥ cutoff ≥ final k-th best``.
    ``"cluster"`` sorts the queries by estimated work (lanes below the seed
    cutoff) and walks each of :func:`_cluster_groups` groups on its own; a
    query's own merge sequence is unchanged, so the result is bitwise that
    of ``"perq"``.

    ``tables`` and ``walk`` run stages 1 and 4 (by default
    :func:`_lb_tables` and :func:`_lane_walk`, looked up when called; the
    dry run gives its counted forms).  ``walk`` returns a loop (a
    generator, as :func:`_lane_walk`; :func:`_finished` makes one of a
    result) whose result's first four entries are ``(topd, topi, vis,
    stats)``."""
    tables = tables or _lb_tables
    walk = walk or _lane_walk
    Q = qs.shape[0]
    r = metric.band
    _, _, env_lo, env_hi = prep
    db_s, alive_s, ids_s = dev.db[s], dev.alive[s], dev.ids[s]
    Tp = db_s.shape[0]
    device = qs.device
    topd = torch.full((Q, k), _INF, dtype=torch.float32, device=device)
    topi = torch.full((Q, k), -1, dtype=torch.int32, device=device)
    if Tp == 0:                                              # empty shard
        return (topd, topi, torch.zeros(Q, dtype=torch.int32, device=device),
                torch.zeros(4, dtype=torch.int64, device=device))
    kseed = min(k, Tp)

    # ---- stage 1: LB tables over every lane --------------------------------
    lbk_all, lbi_all = tables(db_s, alive_s, qs, env_lo, env_hi, r)

    # ---- stage 2: per-query lane order, ascending LB_Improved --------------
    lbi_s, order = torch.sort(lbi_all, dim=1, stable=True)
    lbk_s = torch.gather(lbk_all, 1, order)
    del lbk_all

    # ---- stage 3: seed DP over each query's k best-LB lanes ----------------
    seed_idx = order[:, :kseed].contiguous()
    seed_ok = torch.isfinite(lbi_s[:, :kseed])               # dead lanes: inf
    d2s = ops.dtw_band(qs, db_s, seed_ok,
                       torch.full((Q,), _INF, device=device), r,
                       idx=seed_idx)
    idt = torch.where(torch.isinf(d2s), -1, ids_s[seed_idx])
    topd, topi = ops.topk_merge(topd, topi, d2s, idt)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    st = torch.stack([seed_ok.sum(), zero, zero,
                      (seed_ok & torch.isinf(d2s)).sum()])

    # ---- stage 4: gather-chunk walk of the sorted ranks --------------------
    G = _cluster_groups(Q) if metric.order == "cluster" else 1
    if G == 1:
        topd, topi, vis, stw = (yield from walk(
            db_s, ids_s, qs, order, lbi_s, lbk_s, topd, topi, r, kseed))[:4]
        return topd, topi, vis, st + stw
    # cluster: group queries by estimated work at the seed cutoff
    est = (lbi_all < topd[:, k - 1][:, None]).sum(dim=1)
    perm = torch.argsort(est, stable=True)
    inv = torch.argsort(perm, stable=True)
    Qg = Q // G
    parts = []
    for g in range(G):
        rows = perm[g * Qg:(g + 1) * Qg]
        parts.append((yield from walk(
            db_s, ids_s, qs[rows], order[rows], lbi_s[rows], lbk_s[rows],
            topd[rows], topi[rows], r, kseed)))
    topd = torch.cat([p[0] for p in parts])[inv]
    topi = torch.cat([p[1] for p in parts])[inv]
    vis = torch.cat([p[2] for p in parts])[inv]
    return topd, topi, vis, st + sum(p[3] for p in parts)


def _finished(result):
    """``result`` as a loop that makes no host read: a generator that
    returns it at once (the dry run's counted walk, which reads nothing)."""
    yield from ()
    return result


def _finalize_exact(index: DumpyIndex, qs: np.ndarray, ids_dev: np.ndarray,
                    k: int, metric: Metric = ED
                    ) -> tuple[np.ndarray, np.ndarray]:
    """k-sized host re-rank for bitwise parity with ``search.exact_search``:
    recompute candidate distances with the host math (direct-difference ED,
    or the float64 ``dtw_np`` DP the host heap compares) and sort by (d, id)
    — exactly the host heap's order.  This is also what makes the result
    independent of ``torch.topk``'s order among equal device distances.
    Device invalid slots (``id -1``) stay padded as ``-1 / inf``."""
    Q, kk = ids_dev.shape
    if index.db.shape[0] == 0:                              # empty collection
        return (np.full((Q, k), -1, np.int64),
                np.full((Q, k), np.inf, np.float32))
    cand = index.db[np.maximum(ids_dev, 0)]                 # [Q, kk, n]
    if metric.is_dtw:
        # f64 vectorized DP (each cell fl64(fl32(d*d) + min(...)) in the
        # host's cell order); agrees with the scalar dtw_np to float32
        d = dtw_np_batch(qs, cand, metric.band)
    else:
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
                              device: str | torch.device = "cuda",
                              mesh=None):
    """Batched exact kNN: ``qs [Q, n]`` → ``(ids [Q, k], d [Q, k],
    spans_visited [Q])``.  Results match ``search.exact_search`` per query
    (fuzzy duplicates deduplicated on device, tombstones skipped,
    ``k > n_alive`` truncates); short results pad with ``id -1 / d inf``.

    Runs on ``device`` (CUDA unless the caller asks for ``"cpu"``; raises
    where CUDA is absent), or on the device of a given ``dev``.
    ``n_shards`` picks the ``[S, ...]`` layout of the cached
    ``DeviceIndex``; the result is bitwise the same for every shard count.
    With ``mesh`` (``repro_torch.distributed.sharding.Mesh``), or a ``dev``
    placed on one, the index has one shard per mesh entry and each shard's
    span loop runs on its own device; the result is the same bitwise.
    ``shard_health`` (a length-``n_shards`` bool sequence, or a ``dev``
    whose ``shard_health`` is set) enables degraded mode: dead shards are
    masked out of the merge and the return tuple gains a trailing
    ``coverage`` float.

    ``metric="dtw"`` shares the ED layout and runs the LB_Keogh →
    LB_Improved → band-DP cascade under the candidate ordering ``order``
    (default ``"cluster"``, see ``core.metric.ORDERS``).
    ``return_stats=True`` appends a dict: the cascade counters
    (:data:`STAT_KEYS` + ``dp_survivors``, all zero for ED) and
    ``host_syncs``, the device→host syncs of the search loops."""
    qs = _validate_queries(qs, index.n)
    met = resolve(metric, qs.shape[1], band, order)
    if dev is None:
        dev = index.device_index(chunk=chunk, n_shards=n_shards,
                                 device=device, mesh=mesh)
    want_cov = shard_health is not None or dev.shard_health is not None
    if shard_health is not None:
        dev = dev.with_shard_health(shard_health)
    sax = index.params.sax
    qs_dev = torch.from_numpy(qs).to(dev.device)
    prep, _ = _prep_batch(met, qs_dev, sax.w, sax.b)
    # +8 slack: the loop ranks by f32 device math (the |q|²+|x|²-2qx form
    # for ED, the f32 band DP for DTW) whose rounding can swap near-ties
    # across the k boundary; the host re-rank then picks the true top-k
    # from the widened set
    kk = _result_margin(dev, k) + 8

    def _launch():
        failpoint("search.shard_merge")
        return _exact_knn_sharded(dev, prep, qs_dev, k=kk, metric=met)

    _, ids, visited, st, syncs = with_retries(_launch,
                                              site="search.shard_merge")
    ids_out, d_out = _finalize_exact(index, qs, ids.cpu().numpy(), k, met)
    out = [ids_out, d_out, visited.cpu().numpy()]
    if want_cov:
        out.append(shard_coverage(index, dev))
    if return_stats:
        st = st.tolist()
        stats = dict(zip(STAT_KEYS, st))
        stats["dp_survivors"] = st[0] - st[1] - st[2] - st[3]
        stats["host_syncs"] = syncs
        out.append(stats)
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


# ---------------------------------------------------------------------------
# batched approximate search (vectorized root→leaf descent)
# ---------------------------------------------------------------------------

def _route_edges(sax_q: torch.Tensor, cur: torch.Tensor,
                 node_csl: torch.Tensor, node_shift: torch.Tensor,
                 node_lam: torch.Tensor, edge_parent: torch.Tensor,
                 edge_sid: torch.Tensor, edge_lb: torch.Tensor
                 ) -> torch.Tensor:
    """One routing step for a query batch sitting at internal nodes ``cur``:
    recompute each query's sid from the node's chosen segments (promoteiSAX
    bit extraction), match it against the node's edge span, and fall back to
    the min-LB child for empty regions — bit-for-bit the host descent,
    including its tie-breaking (the first matching edge; the first of equal
    bounds, as the host's ``min`` over ``children`` in insertion order).
    Returns the taken edge index per query."""
    w = sax_q.shape[1]
    lam_max = node_csl.shape[1]
    pos = torch.arange(lam_max, device=sax_q.device)
    curc = cur.clamp(0, node_csl.shape[0] - 1)
    csl = node_csl[curc]                        # [Q, lam_max]
    shift = node_shift[curc]
    lam = node_lam[curc][:, None]
    segs = csl.clamp(0, w - 1).long()
    bits = (torch.gather(sax_q, 1, segs) >> shift) & 1
    weights = torch.where(
        pos[None, :] < lam,
        torch.bitwise_left_shift(torch.ones_like(bits),
                                 (lam - 1 - pos[None, :]).clamp_min(0)), 0)
    sid = (bits * weights).sum(dim=1)           # [Q]
    eligible = edge_parent[None, :] == curc[:, None]              # [Q, E]
    hit = eligible & (edge_sid[None, :] == sid[:, None])
    # argmax / argmin return the first of equal values (torch documents it)
    hit_idx = hit.to(torch.uint8).argmax(dim=1)
    fb_idx = torch.where(eligible, edge_lb, _INF).argmin(dim=1)
    return torch.where(hit.any(dim=1), hit_idx, fb_idx)


def _descend_device(dev: DeviceIndex, sax_q: torch.Tensor,
                    edge_lb: torch.Tensor) -> torch.Tensor:
    """Lockstep root→leaf routing of a query batch over the flat tables —
    the host ``search.route_to_leaf`` vectorized, one step per tree level
    (``dev.depth`` steps, no host sync inside).  Returns the leaf id per
    query."""
    Q = sax_q.shape[0]
    cur = torch.zeros(Q, dtype=torch.int64, device=sax_q.device)
    leaf = torch.full((Q,), -1, dtype=torch.int64, device=sax_q.device)
    for _ in range(dev.depth):
        active = leaf < 0                       # leaf stays -1 en route
        e = _route_edges(sax_q, cur, dev.node_csl, dev.node_shift,
                         dev.node_lam, dev.rt_parent, dev.rt_sid, edge_lb)
        nxt_leaf = dev.rt_leaf[e].long()
        leaf = torch.where(active, nxt_leaf, leaf)
        cur = torch.where(active & (nxt_leaf < 0), dev.rt_child[e].long(),
                          cur)
    return leaf


def _merge_leaf_rank(dist2, db: torch.Tensor, ids: torch.Tensor,
                     alive: torch.Tensor, starts: torch.Tensor,
                     sizes: torch.Tensor, cols: torch.Tensor,
                     topd: torch.Tensor, topi: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge one leaf rank into the running top-k: gather each query's leaf
    rows ``starts + cols`` of ``db [T, n]`` (``[Q, lmax, n]``, clamped into
    range; columns past ``sizes`` and dead rows masked), rank them with
    ``dist2(cand, valid, cutoff2)`` (:func:`_dist2_gather` or, in a serving
    bucket, :func:`_dist2_gather_mixed`) against the running k-th best (the
    DTW cutoff) and merge.  Masked rows come back as ``id -1 / d2 inf``."""
    rows_c = (starts[:, None] + cols[None, :]).clamp(0, db.shape[0] - 1)
    cand = db[rows_c]                                        # [Q, lmax, n]
    valid = (cols[None, :] < sizes[:, None]) & alive[rows_c]
    d2 = dist2(cand, valid, topd[:, -1].contiguous())
    del cand
    idt = torch.where(torch.isinf(d2), -1, ids[rows_c])
    return ops.topk_merge(topd, topi, d2, idt)


def _leaf_topk_device(dev: DeviceIndex, qs: torch.Tensor, prep: tuple,
                      lbq: torch.Tensor, routed: torch.Tensor, *, k: int,
                      kk: int, nbr: int, metric: Metric = ED
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scan the routed leaf (plus the ``nbr-1`` next-best leaves by the
    metric's leaf bound) of every query over the flattened ``[S·Tp, n]``
    shard layout and return the deduped top-k: ``(ids [Q,k], d2 [Q,k],
    leaves [Q,nbr])``.  Invalid slots come back as ``id -1 / d2 inf``.

    The leaves are picked by a stable ascending sort of the bounds with the
    routed leaf forced first (``-inf``): equal bounds keep the lower leaf id
    first, as ``lax.top_k`` does (``torch.topk`` does not promise an order
    among equal values, and the interval MINDIST is 0 for every leaf whose
    region holds the query).  Leaves are scanned one rank at a time with a
    running top-k merge, so the peak temporary is ``[Q, lmax, n]``, never
    ``[Q, nbr, lmax, n]``; the running k-th best feeds the DTW cutoff, so
    later ranks prune against what earlier ranks found.

    The flattened view needs the shards as one ``[S, Tp, n]`` tensor; a
    placed index holds them as separate tensors (on the devices of a mesh),
    so its ranks are scanned shard by shard (:func:`_scan_leaf_schedule`,
    local top-``kk`` lists merged by the same dedup), which gives the same
    result bitwise.  One view is kept for the unplaced layout: each rank is
    one gather there, where the shard-by-shard scan makes one a shard
    (``scripts/probe_leaf_scan.py``)."""
    Q = qs.shape[0]
    lmax, device = dev.lmax, qs.device
    # a scatter of the scalar, not ``scores[rows, routed] = -inf``: on a
    # CUDA tensor that assignment stages the scalar in host memory and
    # copies it up, a host sync
    scores = lbq.scatter(1, routed[:, None], -_INF)
    leaves = torch.sort(scores, dim=1, stable=True).indices[:, :nbr]
    if not isinstance(dev.db, torch.Tensor):
        d2f, idf = _scan_leaf_schedule(dev, leaves, _gather_dist2(metric),
                                       (qs, prep), k=kk)
        return idf[:, :k], d2f[:, :k], leaves.to(torch.int32)
    db_flat = dev.db.reshape(-1, dev.n)
    ids_flat = dev.ids.reshape(-1)
    alive_flat = dev.alive.reshape(-1)
    hm = dev.health_mask
    if hm is not None:
        # degraded mode on the flattened view: rows of dead shards read as
        # tombstoned, so their candidates never enter a merge
        alive_flat = alive_flat & hm[:, None].expand(
            -1, dev.shard_rows).reshape(-1)
    cols = torch.arange(lmax, device=device)
    topd = torch.full((Q, kk), _INF, dtype=torch.float32, device=device)
    topi = torch.full((Q, kk), -1, dtype=torch.int32, device=device)
    dist2 = functools.partial(_gather_dist2(metric), (qs, prep))
    for j in range(nbr):
        starts = dev.leaf_start[leaves[:, j]].long()         # [Q] flattened
        topd, topi = _merge_leaf_rank(
            dist2, db_flat, ids_flat, alive_flat, starts,
            dev.leaf_size[leaves[:, j]], cols, topd, topi)
    d2f, idf = _dedup_topk(topd, topi, k)                    # segment-min dedup
    return idf, d2f, leaves.to(torch.int32)


def _gather_dist2(metric: Metric):
    """The ``dist2(inputs, cand, valid, cutoff2)`` of a leaf scan at one
    metric, ``inputs = (qs, prep)`` on the candidates' device."""
    def dist2(inputs, cand, valid, cutoff2):
        qs, prep = inputs
        return _dist2_gather(metric, qs, prep, cand, valid, cutoff2)
    return dist2


def _approx_knn_device(dev: DeviceIndex, prep: tuple, sax_q: torch.Tensor,
                       qs: torch.Tensor, *, k: int, kk: int, nbr: int,
                       metric: Metric = ED
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole approximate path on the device (descent + leaf scan).
    Returns ``(ids [Q,k], d2 [Q,k], leaves [Q,nbr])``; a degenerate tree
    (the root is the only leaf) routes every query to leaf 0, as the host
    path does."""
    lbq = ops.lb_paa_interval(prep[0], prep[1], dev.leaf_lo_g, dev.leaf_hi_g,
                              dev.n)
    if dev.node_lam.shape[0] == 0:   # degenerate tree: the root is the only leaf
        routed = torch.zeros(qs.shape[0], dtype=torch.int64, device=qs.device)
    else:
        edge_lb = ops.lb_paa_interval(prep[0], prep[1], dev.rt_lo, dev.rt_hi,
                                      dev.n)
        routed = _descend_device(dev, sax_q, edge_lb)
    return _leaf_topk_device(dev, qs, prep, lbq, routed, k=k, kk=kk,
                             nbr=nbr, metric=metric)


def approximate_search_device_batch(index: DumpyIndex, qs: np.ndarray, k: int,
                                    nbr: int = 1,
                                    dev: DeviceIndex | None = None,
                                    metric: str | Metric = "ed",
                                    band: int | None = None,
                                    n_shards: int = 1,
                                    device: str | torch.device = "cuda"
                                    ) -> tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """Batched approximate kNN (paper §5.5 descent, vectorized over queries).

    ``nbr=1`` visits exactly the leaf the host ``approximate_search`` picks
    at the same metric.  ``nbr>1`` widens to the next-best leaves by the
    metric's leaf bound — the serving recall knob; unlike host
    ``extended_search`` the extras are chosen globally, not within the
    target subtree.  Returns ``(ids [Q, k'], d [Q, k'], leaves [Q, nbr])``
    with ``k' = min(k, nbr·max_leaf_size)``; empty slots are ``id -1 /
    d inf``.  Distances are the device's own sums (no host re-rank).  Fuzzy
    replicas sharing a leaf are deduped in the device merge.

    Runs on ``device`` (CUDA unless the caller asks for ``"cpu"``), or on
    the device of a given ``dev``; ``n_shards`` picks the cached layout."""
    qs = _validate_queries(qs, index.n)
    met = resolve(metric, qs.shape[1], band)
    if dev is None:
        dev = index.device_index(n_shards=n_shards, device=device)
    sax_p = index.params.sax
    qs_dev = torch.from_numpy(qs).to(dev.device)
    prep, sax_q = _prep_batch(met, qs_dev, sax_p.w, sax_p.b)

    nbr = min(nbr, dev.n_leaves)
    # fuzzy replicas can share a leaf (sibling packing merges them), so merge
    # with the duplicate margin and segment-min-dedup on device
    kk = min(_result_margin(dev, k), nbr * dev.lmax)
    k_out = min(k, nbr * dev.lmax)
    ids, d2, leaves = _approx_knn_device(dev, prep, sax_q, qs_dev,
                                         k=k_out, kk=kk, nbr=nbr, metric=met)
    return (ids.cpu().numpy().astype(np.int64), np.sqrt(d2.cpu().numpy()),
            leaves.cpu().numpy())


# ---------------------------------------------------------------------------
# batched extended search — Algorithm 4 (sibling subtrees, LB-ordered)
# ---------------------------------------------------------------------------

def _descend_subtree(dev: DeviceIndex, sax_q: torch.Tensor,
                     edge_lb: torch.Tensor, *, nbr: int | torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Root→subtree descent of a query batch: follow sids (min-LB fallback on
    empty regions) while the child subtree still holds more than ``nbr``
    leaves (one budget for the batch, or a serving bucket's ``[Q]`` lane
    budgets, compared lane by lane).  Returns ``(parent node id [Q], stop
    edge index [Q])`` — the stop edge's target is the host descent's stop
    node, its parent the node whose children form the sibling set."""
    Q = sax_q.shape[0]
    z = torch.zeros(Q, dtype=torch.int64, device=sax_q.device)
    cur, pm, se = z, z, z
    done = torch.zeros(Q, dtype=torch.bool, device=sax_q.device)
    for _ in range(dev.depth):
        e = _route_edges(sax_q, cur, dev.node_csl, dev.node_shift,
                         dev.node_lam, dev.rt_parent, dev.rt_sid, edge_lb)
        stop = (~done) & ((dev.rt_leaf[e] >= 0) | (dev.rt_nl[e] <= nbr))
        pm = torch.where(stop, cur.clamp(0, dev.node_csl.shape[0] - 1), pm)
        se = torch.where(stop, e, se)
        done = done | stop
        cur = torch.where(done, cur, dev.rt_child[e].long())
    return pm, se


def _sibling_schedule(dev: DeviceIndex, prep: tuple, lbq: torch.Tensor,
                      pm: torch.Tensor, se: torch.Tensor, *, nbr: int
                      ) -> torch.Tensor:
    """Per-query leaf visit schedule ``[Q, nbr]`` over the stop subtree.

    Mirrors the host order exactly: the target subtree (the stop edge's
    span) ranks first, the remaining siblings of the parent group by
    (interval MINDIST, span begin), and leaves inside every subtree by
    (leaf LB, leaf id); the overall schedule is the ``nbr`` smallest
    (sibling rank, leaf LB, leaf id) keys, which equals the host's
    budget-truncated walk because sibling spans partition the parent span.

    Every query ranks all ``L`` leaves.  The reference sorts a window of
    ``FlatRouting.stop_span_cap`` leaf ids instead, to give XLA a static
    width narrower than ``L``; the window holds the whole parent span, so
    both give the same schedule.  The reference's ``lexsort`` calls are two
    stable sorts each (least significant key first), its ``argsort`` a
    stable sort."""
    Q, L = lbq.shape
    gmax, device = dev.gmax, lbq.device
    seg_lo, seg_hi = prep[0], prep[1]
    i32max = torch.iinfo(torch.int32).max
    tb = dev.rt_begin[se]                                     # [Q]
    goff = dev.grp_off[pm]
    gcnt = dev.grp_off[pm + 1] - goff
    gpos = torch.arange(gmax, dtype=torch.int32, device=device)
    gi = (goff[:, None] + gpos[None, :]).clamp(
        0, dev.grp_begin.shape[0] - 1).long()                 # [Q, gmax]
    valid = gpos[None, :] < gcnt[:, None]
    m_begin = torch.where(valid, dev.grp_begin[gi], i32max)
    # member interval MINDIST (squared — order-equal to the host sqrt form),
    # summed in one fixed order, so the CPU and the card rank near-tied
    # members alike
    below = torch.clamp_min(dev.grp_lo[gi] - seg_hi[:, None, :], 0.0)
    above = torch.clamp_min(seg_lo[:, None, :] - dev.grp_hi[gi], 0.0)
    d = torch.maximum(below, above)
    sib_lb = (dev.n / dev.w) * sum_last_fixed(d * d)         # [Q, gmax]
    sib_lb = torch.where(valid, sib_lb, _INF)
    sib_lb = torch.where(m_begin == tb[:, None], -_INF, sib_lb)
    # member visit rank: (LB, span begin), target forced first by the -inf
    perm = _lexsort2(m_begin, sib_lb)
    rank = torch.argsort(perm, dim=1)                         # inverse perm
    nb, ne = dev.node_begin[pm][:, None], dev.node_end[pm][:, None]
    # owning member of every leaf: spans are begin-sorted and partition the
    # parent span, so one searchsorted per query resolves it
    leaf_ids = torch.arange(L, dtype=torch.int32, device=device)
    sidx = torch.searchsorted(m_begin, leaf_ids.expand(Q, L).contiguous(),
                              right=True) - 1
    leaf_rank = torch.gather(rank, 1, sidx.clamp(0, gmax - 1))
    under = (leaf_ids[None, :] >= nb) & (leaf_ids[None, :] < ne)
    leaf_rank = torch.where(under, leaf_rank, gmax + 1)
    order = _lexsort2(lbq, leaf_rank)                         # stable → id
    return order[:, :nbr].to(torch.int32)


def _scan_leaf_schedule(dev: DeviceIndex, leaves: torch.Tensor, dist2,
                        inputs: tuple, *, k: int,
                        lane_nbr: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Visit the per-query leaf schedule shard by shard and merge.

    Shard ``s`` owns the contiguous leaf range ``leaf_bounds[s:s+2]`` of
    the leaf-aligned layout; it scans only the scheduled leaves inside that
    range (the rest mask to ``+inf``), producing a local ``[Q, k]`` top-k.
    The ``[S, Q, k]`` locals then merge exactly like the exact path (dead
    shards masked, segment-min dedup, top-k), so results are bitwise
    invariant to the shard count.  Candidate distances go through
    ``dist2(inputs, cand, valid, cutoff2)`` (:func:`_merge_leaf_rank`),
    ``inputs`` being the query-side tensors on the shard's device, so DTW
    candidates prune against the shard-local running k-th best.
    ``lane_nbr [Q]`` (a serving bucket's per-lane budgets) scans rank ``j``
    of lane ``q`` only while ``j < lane_nbr[q]``.

    On a mesh each shard scans on its own device, with the schedule and
    ``inputs`` copied there once and the global tables read from that
    device's copy (``dev.on``); its ``[Q, k]`` locals move to
    ``dev.device`` for the merge."""
    Q, nbr = leaves.shape
    lmax, L = dev.lmax, dev.n_leaves
    Tp, home = dev.shard_rows, dev.device
    on = _replicator((leaves, leaves.clamp(0, L - 1).long(),
                      torch.arange(lmax, device=home), lane_nbr, inputs),
                     home)
    parts = []
    for s in range(dev.n_shards):
        device = dev.shard_device(s)
        loc = dev.on(device)
        leaves_s, lfc, cols, lane_nbr_s, inputs_s = on(device)
        a, z = dev.leaf_bounds[s], dev.leaf_bounds[s + 1]
        with _current(device):
            topd = torch.full((Q, k), _INF, dtype=torch.float32,
                              device=device)
            topi = torch.full((Q, k), -1, dtype=torch.int32, device=device)
            for j in range(nbr):
                mine = (leaves_s[:, j] >= a) & (leaves_s[:, j] < z)
                if lane_nbr_s is not None:
                    mine &= j < lane_nbr_s
                starts = loc.leaf_start[lfc[:, j]].long() - s * Tp  # local
                sizes = torch.where(mine, loc.leaf_size[lfc[:, j]], 0)
                topd, topi = _merge_leaf_rank(
                    functools.partial(dist2, inputs_s), dev.db[s],
                    dev.ids[s], dev.alive[s], starts, sizes, cols, topd,
                    topi)
        parts.append(_to_device((topd, topi), home))
    topd = torch.stack([p[0] for p in parts])                 # [S, Q, k]
    topi = torch.stack([p[1] for p in parts])
    topd, topi, _, _ = _mask_dead_shards(dev, topd, topi)
    S = topd.shape[0]
    alld = topd.permute(1, 0, 2).reshape(Q, S * k)
    alli = topi.permute(1, 0, 2).reshape(Q, S * k)
    return _dedup_topk(alld, alli, k)


def _extended_knn_sharded(dev: DeviceIndex, prep: tuple,
                          sax_q: torch.Tensor, qs: torch.Tensor, *, k: int,
                          nbr: int, subtree: bool, metric: Metric = ED
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Batched Alg. 4: descent → sibling schedule → shard-local scan → dedup
    merge.  Returns ``(d2 [Q,k], ids [Q,k], leaves [Q,nbr])``.  With
    ``subtree=False`` (the whole tree fits the ``nbr`` budget, or the root
    is the only leaf) the schedule is simply every leaf by (LB, leaf id) —
    the host's ``parent is None`` branch.  All bounds are the metric's
    interval MINDIST."""
    lbq = ops.lb_paa_interval(prep[0], prep[1], dev.leaf_lo_g, dev.leaf_hi_g,
                              dev.n)
    if subtree:
        edge_lb = ops.lb_paa_interval(prep[0], prep[1], dev.rt_lo, dev.rt_hi,
                                      dev.n)
        pm, se = _descend_subtree(dev, sax_q, edge_lb, nbr=nbr)
        leaves = _sibling_schedule(dev, prep, lbq, pm, se, nbr=nbr)
    else:
        order = torch.sort(lbq, dim=1, stable=True).indices  # stable → id
        leaves = order[:, :nbr].to(torch.int32)

    d2, ids = _scan_leaf_schedule(dev, leaves, _gather_dist2(metric),
                                  (qs, prep), k=k)
    return d2, ids, leaves


def extended_search_device_batch(index: DumpyIndex, qs: np.ndarray, k: int,
                                 nbr: int = 1, chunk: int = 2048,
                                 n_shards: int = 1,
                                 dev: DeviceIndex | None = None,
                                 rerank: bool = True,
                                 metric: str | Metric = "ed",
                                 band: int | None = None,
                                 shard_health=None,
                                 device: str | torch.device = "cuda",
                                 mesh=None):
    """Batched extended approximate kNN (paper Alg. 4, vectorized over
    queries): ``qs [Q, n]`` → ``(ids [Q, k], d [Q, k], leaves [Q, nbr'])``
    with ``nbr' = min(nbr, n_leaves)``; short results pad ``id -1 / d inf``.

    The visit set per query is exactly the host ``extended_search`` schedule
    at the same metric (target subtree first, then LB-ordered siblings,
    LB-ordered leaves within), so ``nbr=1`` degenerates to the approximate
    answer and the k-th distance is monotone in ``nbr``.  ``n_shards``
    picks the cached ``[S, ...]`` layout: the leaf scan runs shard by shard
    and merges through the same segment-min dedup as the exact path,
    bitwise invariant to the shard count.  ``mesh`` places one shard on
    each of its entries, as in :func:`exact_search_device_batch`.

    ``rerank=True`` (default) finishes with the k-sized host re-rank
    (:func:`_finalize_exact`) for bitwise (ids, dists) parity with
    ``extended_search``; ``rerank=False`` keeps the whole path on the
    device (ids ordered by the device d², distances returned as ``sqrt`` of
    the device form).

    ``shard_health`` enables degraded mode exactly as in
    :func:`exact_search_device_batch` (dead shards masked from the scan and
    merge; a trailing ``coverage`` float joins the return tuple).  Runs on
    ``device`` (CUDA unless the caller asks for ``"cpu"``), or on the device
    of a given ``dev``."""
    qs = _validate_queries(qs, index.n)
    met = resolve(metric, qs.shape[1], band)
    if dev is None:
        dev = index.device_index(chunk=chunk, n_shards=n_shards,
                                 device=device, mesh=mesh)
    want_cov = shard_health is not None or dev.shard_health is not None
    if shard_health is not None:
        dev = dev.with_shard_health(shard_health)
    sax_p = index.params.sax
    qs_dev = torch.from_numpy(qs).to(dev.device)
    prep, sax_q = _prep_batch(met, qs_dev, sax_p.w, sax_p.b)
    L = dev.n_leaves
    nbr_eff = max(min(int(nbr), L), 1)
    subtree = dev.node_lam.shape[0] > 0 and L > nbr_eff
    kk = _result_margin(dev, k) + (8 if rerank else 0)
    d2, ids, leaves = _extended_knn_sharded(dev, prep, sax_q, qs_dev,
                                            k=kk, nbr=nbr_eff,
                                            subtree=subtree, metric=met)
    if rerank:
        ids_out, d_out = _finalize_exact(index, qs, ids.cpu().numpy(), k, met)
        out = [ids_out, d_out, leaves.cpu().numpy()]
    else:
        out = [ids.cpu().numpy()[:, :k].astype(np.int64),
               np.sqrt(d2.cpu().numpy())[:, :k], leaves.cpu().numpy()]
    if want_cov:
        out.append(shard_coverage(index, dev))
    return tuple(out)


# ---------------------------------------------------------------------------
# bucketed serving search — every per-request knob (k / nbr / metric /
# liveness) a lane array, so a coalescing front-end serves any knob mix with
# the same code path per bucket shape (docs/serving.md: the masking contract)
# ---------------------------------------------------------------------------

def _dist2_gather_mixed(qs: torch.Tensor, prep: tuple, cand: torch.Tensor,
                        valid: torch.Tensor, cutoff2: torch.Tensor,
                        lane_dtw: torch.Tensor, band: int, has_dtw: bool
                        ) -> torch.Tensor:
    """Per-lane metric blend of :func:`_dist2_gather`: ED lanes pay the
    direct-difference sum, DTW lanes the LB_Keogh → LB_Improved → masked
    band DP cascade (the ``lb_keogh``, ``lb_improved`` and ``dtw_band``
    kernels in their per-query layout).

    ``has_dtw`` is the host's ``lane_dtw.any()``: an all-ED bucket launches
    no DTW kernel at all.  Bitwise per lane: each lane's value is
    :func:`_dist2_gather`'s for its metric (a DTW lane's against this
    bucket's running cutoff), and the blend only selects between the two
    results, never mixes them."""
    sel = lane_dtw[:, None]
    d2_ed = _dist2_gather(ED, qs, prep, cand, valid & ~sel, cutoff2)
    if not has_dtw:
        return d2_ed
    d2_dtw = _dist2_gather(Metric("dtw", band), qs, prep, cand, valid & sel,
                           cutoff2)
    return torch.where(sel, d2_dtw, d2_ed)


def _scan_bucket_schedule(dev: DeviceIndex, qs: torch.Tensor, prep: tuple,
                          leaves: torch.Tensor, lane_nbr: torch.Tensor,
                          lane_dtw: torch.Tensor, *, k: int, band: int,
                          has_dtw: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_scan_leaf_schedule` with per-lane masking: schedule rank ``j``
    is scanned for lane q only while ``j < lane_nbr[q]`` (a dead or padded
    lane has ``lane_nbr == 0`` and scans nothing — its gathers still run
    over clamped rows, but every candidate masks to ``+inf / -1``), and the
    candidate distance blends ED and the DTW cascade per lane
    (:func:`_dist2_gather_mixed`)."""
    def dist2(inputs, cand, valid, cutoff2):
        qs, prep, lane_dtw = inputs
        return _dist2_gather_mixed(qs, prep, cand, valid, cutoff2, lane_dtw,
                                   band, has_dtw)

    return _scan_leaf_schedule(dev, leaves, dist2, (qs, prep, lane_dtw),
                               k=k, lane_nbr=lane_nbr)


def _bucket_knn_sharded(dev: DeviceIndex, prep_ed: tuple, prep_dtw: tuple,
                        sax_q: torch.Tensor, qs: torch.Tensor,
                        lane_nbr: torch.Tensor, lane_dtw: torch.Tensor, *,
                        kk: int, nbr_max: int, subtree: bool, band: int,
                        has_dtw: bool
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bucketed serving program: extended (Alg. 4) search where every
    per-request knob is a lane array, so one code path per bucket shape
    serves any ``k``/``nbr``/``metric`` mix.  Returns ``(d2 [Q, kk],
    ids [Q, kk], leaves [Q, nbr_max])`` on the device.

    - ``lane_nbr [Q] i32`` — per-lane leaf budget; 0 marks a dead (padding)
      lane.  It reaches the descent's stop test lane by lane, masks the
      schedule scan, and picks flat or subtree per lane (lanes with
      ``nbr >= L`` take the all-leaves flat order, the individual path's
      ``subtree=False`` branch).
    - ``lane_dtw [Q] bool`` — per-lane metric.  The two preps have equal
      shapes; ``torch.where`` on their rows makes every bound, the descent
      and the schedule per-lane correct, and the candidate distance blends
      via :func:`_dist2_gather_mixed`.
    - per-lane ``k`` never reaches the device: the program runs at the full
      dedup margin ``kk`` and the host truncates each lane (the superset
      argument of docs/serving.md).

    The schedule is built at ``nbr_max`` over all ``L`` leaves (the port's
    :func:`_sibling_schedule`, no window); a lane's first ``lane_nbr``
    entries are its own schedule."""
    if has_dtw:
        sel = lane_dtw[:, None]
        prep = tuple(torch.where(sel, pd, pe)
                     for pe, pd in zip(prep_ed, prep_dtw))
    else:
        prep = prep_ed
    lbq = ops.lb_paa_interval(prep[0], prep[1], dev.leaf_lo_g, dev.leaf_hi_g,
                              dev.n)
    L = dev.n_leaves
    flat = torch.sort(lbq, dim=1, stable=True).indices[:, :nbr_max]
    flat = flat.to(torch.int32)                               # stable → id
    if subtree:
        edge_lb = ops.lb_paa_interval(prep[0], prep[1], dev.rt_lo, dev.rt_hi,
                                      dev.n)
        pm, se = _descend_subtree(dev, sax_q, edge_lb, nbr=lane_nbr)
        sub = _sibling_schedule(dev, prep, lbq, pm, se, nbr=nbr_max)
        leaves = torch.where((lane_nbr >= L)[:, None], flat, sub)
    else:
        leaves = flat
    d2, ids = _scan_bucket_schedule(dev, qs, prep, leaves, lane_nbr,
                                    lane_dtw, k=kk, band=band,
                                    has_dtw=has_dtw)
    return d2, ids, leaves


def _upload_async(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device`` without a host wait: staged in
    pinned memory and copied non-blocking (an upload from pageable memory
    waits for the work already queued on the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def bucket_search_launch(index: DumpyIndex, qs_dev: torch.Tensor,
                         lane_nbr, lane_dtw, *, k_max: int, nbr_max: int,
                         band: int | None = None,
                         dev: DeviceIndex | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Queue the bucketed program on an already-staged device query batch —
    the asynchronous half of :func:`bucket_search_device_batch`.  Nothing
    here waits for the device: ``has_dtw`` is read from the host's lane
    array, the lane arrays go up from pinned memory without blocking, and
    every table the program reads is on the device already.  So a
    front-end stages bucket *i+1* while this one computes, and waits only
    in :func:`bucket_search_finish`.

    ``lane_nbr [Q]`` is the per-request leaf budget with 0 marking dead
    (padding) lanes; ``lane_dtw [Q] bool`` selects the metric per lane
    (both host arrays).  Returns device tensors ``(d2 [Q, kk], ids [Q, kk],
    leaves [Q, nbr'])`` at the full dedup margin ``kk =
    _result_margin(dev, k_max)``."""
    if dev is None:
        dev = index.device_index(device=qs_dev.device)
    sax_p = index.params.sax
    band_eff = max(int(band) if band is not None else default_band(dev.n), 1)
    paa_q, sax_q = ops.sax_encode(qs_dev, sax_p.w, sax_p.b)
    prep_ed = query_prep(ED, qs_dev, paa_q)
    lane_dtw = np.asarray(lane_dtw, bool)
    has_dtw = bool(lane_dtw.any())          # host array: no device read
    if has_dtw:
        prep_dtw = query_prep(Metric("dtw", band_eff), qs_dev, paa_q)
    else:
        prep_dtw = prep_ed      # no DTW lane: values unused, shapes identical
    L = dev.n_leaves
    nbr_eff = max(min(int(nbr_max), L), 1)
    subtree = dev.node_lam.shape[0] > 0 and L > 1
    kk = _result_margin(dev, k_max)
    lane_nbr = np.clip(np.asarray(lane_nbr, np.int64), 0, nbr_eff)
    lanes = _upload_async(np.stack([lane_nbr, lane_dtw]).astype(np.int32),
                          dev.device)
    return _bucket_knn_sharded(
        dev, prep_ed, prep_dtw, sax_q.to(torch.int32), qs_dev, lanes[0],
        lanes[1].bool(), kk=kk, nbr_max=nbr_eff, subtree=subtree,
        band=band_eff, has_dtw=has_dtw)


def bucket_search_finish(res, lane_k, lane_nbr, *, k_max: int
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Harvest a :func:`bucket_search_launch` result on the host: one
    device→host copy (d² as its bits, ids and leaves in one ``int32``
    block), then every lane truncated to its own ``k`` (columns ≥ k pad
    ``-1 / inf``) and its schedule to its own ``nbr`` (pad ``-1``).  The
    first ``lane_k[q]`` columns are bitwise the ids and distances
    ``extended_search_device_batch(rerank=False)`` returns for that request
    issued alone (docs/serving.md: the masking contract)."""
    d2, ids, leaves = res
    kk = d2.shape[1]
    block = torch.cat([d2.view(torch.int32), ids.to(torch.int32),
                       leaves.to(torch.int32)], dim=1).cpu().numpy()
    d2 = block[:, :kk].view(np.float32)
    ids = block[:, kk:2 * kk][:, :k_max].astype(np.int64)
    d = np.sqrt(d2[:, :k_max])
    leaves = block[:, 2 * kk:]
    kcol = np.arange(k_max)[None, :] < np.asarray(lane_k, np.int64)[:, None]
    ids = np.where(kcol, ids, -1)
    d = np.where(kcol, d, np.inf).astype(np.float32)
    ncol = np.arange(leaves.shape[1])[None, :] \
        < np.asarray(lane_nbr, np.int64)[:, None]
    return ids, d, np.where(ncol, leaves, -1)


def bucket_search_device_batch(index: DumpyIndex, qs, ks, nbrs,
                               metrics=None, *, k_max: int | None = None,
                               nbr_max: int | None = None,
                               band: int | None = None, chunk: int = 2048,
                               n_shards: int = 1,
                               dev: DeviceIndex | None = None,
                               shard_health=None,
                               device: str | torch.device = "cuda",
                               mesh=None):
    """Coalesced mixed-knob kNN: one device program per batch, every
    per-request knob a lane array — the blocking entry point behind the
    serving front-end (``repro_torch.serving.batching``).

    ``ks``/``nbrs`` give each lane its own ``k`` and leaf budget; a lane
    with ``ks[q] == 0`` is a dead (padding) lane — its query must still be
    finite (pad with zeros) and its result is all ``-1 / inf``.  ``metrics``
    is a per-lane ``"ed"``/``"dtw"`` sequence (or a bool DTW mask; default
    all-ED); ``band`` is the shared DTW band (default ``0.1 n``, matching
    ``resolve``).  ``k_max``/``nbr_max`` pin the program's widths so a
    front-end can hold them constant across calls (defaults: the lane
    maxima).

    Lane q's live columns are bitwise
    ``extended_search_device_batch(index, qs[q:q+1], ks[q], nbr=nbrs[q],
    metric=..., rerank=False)`` — masking absorbs the knob mix
    (``tests/test_torch_serving_batching.py`` pins this, including degraded
    ``shard_health`` and fuzzy+tombstone layouts).  Validation is one
    vectorized pass for the whole batch.

    ``shard_health`` enables degraded mode exactly as in
    :func:`exact_search_device_batch` (dead shards masked from scan and
    merge; a trailing ``coverage`` float joins the return tuple).  Runs on
    ``device`` (CUDA unless the caller asks for ``"cpu"``), on ``mesh``, or
    on the device of a given ``dev``."""
    qs = _validate_queries(qs, index.n)   # one vectorized check per batch
    Q = qs.shape[0]
    ks = np.asarray(ks, np.int64).reshape(-1)
    nbrs = np.asarray(nbrs, np.int64).reshape(-1)
    if ks.shape[0] != Q or nbrs.shape[0] != Q:
        raise ValueError(
            f"ks/nbrs need one entry per query lane: got {ks.shape[0]}/"
            f"{nbrs.shape[0]} for {Q} lanes")
    if (ks < 0).any() or (nbrs < 0).any():
        raise ValueError("per-lane k/nbr must be >= 0 (0 = dead lane)")
    if metrics is None:
        lane_dtw = np.zeros(Q, bool)
    else:
        ms = list(metrics)
        if len(ms) != Q:
            raise ValueError(
                f"metrics needs one entry per query lane: got {len(ms)} "
                f"for {Q} lanes")
        lane_dtw = np.empty(Q, bool)
        for i, m in enumerate(ms):
            if isinstance(m, (bool, np.bool_, int, np.integer)):
                lane_dtw[i] = bool(m)  # lint: allow-sync: a host value
            elif m in ("ed", "dtw"):
                lane_dtw[i] = m == "dtw"
            else:
                raise ValueError(f"lane {i}: unknown metric {m!r}")
    k_max = int(k_max) if k_max is not None else max(int(ks.max()), 1)
    nbr_max = int(nbr_max) if nbr_max is not None else max(int(nbrs.max()), 1)
    over = np.where(ks > k_max)[0]
    if over.size:
        raise ValueError(
            f"lanes {over[:8].tolist()} request k > k_max={k_max}")
    if dev is None:
        dev = index.device_index(chunk=chunk, n_shards=n_shards,
                                 device=device, mesh=mesh)
    want_cov = shard_health is not None or dev.shard_health is not None
    if shard_health is not None:
        dev = dev.with_shard_health(shard_health)
    if index.db.shape[0] == 0:                              # empty collection
        out = [np.full((Q, k_max), -1, np.int64),
               np.full((Q, k_max), np.inf, np.float32),
               np.full((Q, max(nbr_max, 1)), -1, np.int32)]
        if want_cov:
            out.append(shard_coverage(index, dev))
        return tuple(out)
    alive = ks > 0
    nbr_eff = max(min(nbr_max, dev.n_leaves), 1)
    lane_nbr = np.where(alive, np.clip(nbrs, 1, nbr_eff), 0)
    lane_dtw = lane_dtw & alive        # dead lanes stay on the ED fast path
    qs_dev = torch.from_numpy(qs).to(dev.device)

    def _launch():
        failpoint("search.shard_merge")
        return bucket_search_launch(index, qs_dev, lane_nbr, lane_dtw,
                                    k_max=k_max, nbr_max=nbr_max,
                                    band=band, dev=dev)

    res = with_retries(_launch, site="search.shard_merge")
    ids, d, leaves = bucket_search_finish(
        res, np.where(alive, np.minimum(ks, k_max), 0), lane_nbr,
        k_max=k_max)
    out = [ids, d, leaves]
    if want_cov:
        out.append(shard_coverage(index, dev))
    return tuple(out)
