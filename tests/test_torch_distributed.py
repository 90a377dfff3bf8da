"""The port's distributed build and search (``repro_torch.core.distributed``,
``repro_torch.distributed.sharding``, ``DeviceIndex.shard``) against the
reference's ``repro.core.distributed`` and the host search, on the CPU.

A port mesh of four ``"cpu"`` entries stands in for the reference's forced
four-device host mesh (``tests/test_distributed.py`` runs that in a
subprocess): every shard's program runs through the per-device code, each
shard's tensors on its own mesh entry, and the results must be bitwise those
of one shard, of the reference's one-device search and of the host search.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_port import (assert_ties_only, build_pair, clear_of_breakpoints,
                         params_pair, torch_threads)  # noqa: F401
from repro.core.device_index import DeviceIndex as RDev
from repro.core.distributed import build_distributed as r_build_distributed
from repro.core.distributed import build_step as r_build_step
from repro.core.distributed import search_distributed as r_search_dist
from repro.core.distributed import search_step as r_search_step
from repro.core.sax import next_bit_codes_jnp, sax_encode_np as r_encode
from repro.core.search import exact_search, extended_search
from repro.core.search_device import exact_search_device_batch as r_exact
from repro.core.search_device import extended_search_device_batch as r_ext
from repro.core.search_device import shard_coverage as r_coverage
from repro.data.series import random_walks
from repro_torch.core import distributed as D
from repro_torch.core import search_device as sd
from repro_torch.core.baselines.brute import brute_force_knn
from repro_torch.core.distributed import (_topk_lowest, build_distributed,
                                          build_step, encode_distributed,
                                          search_distributed, search_step)
from repro_torch.core.metric import resolve
from repro_torch.core.sax import next_bit_codes_t
from repro_torch.distributed.sharding import get_mesh, make_mesh, use_mesh

CPU = "cpu"
K = 5
VICTIMS = (3, 17)


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh([CPU] * 4)


@pytest.fixture(scope="module")
def fuzzy():
    """The reference test's index: 1200 x 64, fuzzy, two tombstones."""
    ri, pi = build_pair(random_walks(1200, 64, seed=2), th=64,
                        fuzzy_f=0.15)
    assert pi.stats.n_duplicates > 0
    for v in VICTIMS:
        ri.delete(v)
        pi.delete(v)
    return ri, pi


def _clear_rows(db, w=8, b=8):
    """Rows whose every PAA value lies clear of the breakpoints (symbols
    agree whatever the float32 summation order)."""
    paa, _ = r_encode(db, params_pair(w=w, b=b)[0].sax)
    return db[clear_of_breakpoints(paa, b).all(axis=1)]


# ---------------------------------------------------------------------------
# device programs against the reference's
# ---------------------------------------------------------------------------

def test_build_step_matches_host_encoder():
    db = _clear_rows(random_walks(700, 64, seed=0))[:512]
    paa, sax, hist = build_step(torch.from_numpy(db), 8, 8)
    r_paa, r_sax, r_hist = r_build_step(jnp.asarray(db), 8, 8)
    np.testing.assert_allclose(paa.numpy(), np.asarray(r_paa), atol=1e-5)
    np.testing.assert_array_equal(sax.numpy(), np.asarray(r_sax))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(r_hist))
    paa_h, sax_h = r_encode(db, params_pair()[0].sax)
    np.testing.assert_allclose(paa.numpy(), paa_h, atol=1e-4)
    np.testing.assert_array_equal(sax.numpy(), sax_h)
    assert int(hist.sum()) == len(db)             # histogram covers all


@pytest.mark.parametrize("w,b", [(8, 8), (16, 8), (4, 3)])
def test_next_bit_codes_match_reference(w, b):
    rng = np.random.default_rng(w * b)
    sax = rng.integers(0, 1 << b, (300, w)).astype(np.uint8)
    card = rng.integers(0, b, w).astype(np.int32)
    got = next_bit_codes_t(torch.from_numpy(sax), torch.from_numpy(card),
                           w, b)
    want = next_bit_codes_jnp(jnp.asarray(sax), jnp.asarray(card), w, b)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_search_step_returns_per_query_min_lb():
    """The twin of the reference's regression: ``lbs`` is ``[Q]`` and its
    square root lower-bounds each query's nearest distance; positions and
    distances are the reference's (ties only, rtol 1e-5), ``lbs`` within
    rtol 1e-6."""
    ri, pi = build_pair(random_walks(512, 64, seed=4))
    q = random_walks(7, 64, seed=5)
    t = torch.from_numpy
    ids, d, lbs = search_step(t(q), t(pi.db_ordered), t(pi.flat.leaf_lo),
                              t(pi.flat.leaf_hi), 3)
    r_ids, r_d, r_lbs = r_search_step(
        jnp.asarray(q), jnp.asarray(ri.db_ordered),
        jnp.asarray(ri.flat.leaf_lo), jnp.asarray(ri.flat.leaf_hi), 3)
    assert lbs.shape == (7,) and ids.shape == (7, 3) and d.shape == (7, 3)
    np.testing.assert_allclose(lbs.numpy(), np.asarray(r_lbs), rtol=1e-6)
    assert_ties_only(ids.numpy(), d.numpy(), np.asarray(r_ids),
                     np.asarray(r_d))
    assert np.all(np.sqrt(lbs.numpy()) <= d[:, 0].numpy() + 1e-4)


def test_topk_lowest_keeps_the_lower_position_among_ties():
    d2 = torch.tensor([[3.0, 1.0, 1.0, -0.0, 0.0, -2.0, 1.0],
                       [5.0, 5.0, 5.0, 5.0, 4.0, 5.0, 5.0]])
    got = _topk_lowest(d2, 5).tolist()
    assert got == [[5, 3, 4, 1, 2], [4, 0, 1, 2, 3]]
    rng = np.random.default_rng(1)
    x = rng.integers(0, 20, (6, 300)).astype(np.float32) - 5
    want = np.argsort(x, axis=1, kind="stable")[:, :17]
    np.testing.assert_array_equal(_topk_lowest(torch.from_numpy(x), 17),
                                  want)


@pytest.mark.parametrize("n_dev", [1, 3])
def test_distributed_build_and_search_equal_host_path(n_dev):
    """The twin of the reference's: the mesh build gives the reference's
    layout (data clear of breakpoints), and search_distributed's exact
    answers equal the port's brute force."""
    rp, pp = params_pair()
    db = _clear_rows(random_walks(3300, 64, seed=1))[:3000]
    mesh = make_mesh([CPU] * n_dev)
    idx = build_distributed(db, pp, mesh=mesh)
    ref = r_build_distributed(db, rp)
    np.testing.assert_array_equal(idx.flat.order, ref.flat.order)
    np.testing.assert_array_equal(idx.flat.leaf_offsets,
                                  ref.flat.leaf_offsets)
    np.testing.assert_array_equal(idx.sax, np.asarray(ref.sax))
    assert vars(idx.stats) == vars(ref.stats)
    qs = random_walks(4, 64, seed=99)
    ids, d = search_distributed(idx, qs, k=K, mesh=mesh)
    for i, q in enumerate(qs):
        gt_ids, gt_d = brute_force_knn(db, q, K)
        np.testing.assert_array_equal(ids[i], gt_ids)
        np.testing.assert_allclose(d[i], gt_d, rtol=1e-5)


def test_encode_distributed_is_shard_count_invariant():
    db = random_walks(1001, 64, seed=6)
    one = encode_distributed(db, 8, 8, mesh=make_mesh([CPU]))
    four = encode_distributed(db, 8, 8, mesh=make_mesh([CPU] * 4))
    for a, b in zip(one, four):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(four[2].sum()) == 1001


# ---------------------------------------------------------------------------
# the sharded search paths on a four-entry mesh
# ---------------------------------------------------------------------------

def test_sharded_search_mesh_bitwise_parity(fuzzy, mesh4):
    """The twin of the reference's multi-device subprocess test: exact and
    extended (nbr 1, 4) on the four-entry mesh bitwise equal one shard,
    the reference's one-device search and the host search (fuzzy
    duplicates deduplicated, tombstones respected)."""
    ri, pi = fuzzy
    qs = random_walks(6, 64, seed=11)
    ids1, d1, _ = sd.exact_search_device_batch(pi, qs, K, device=CPU)
    ids4, d4, _ = sd.exact_search_device_batch(pi, qs, K, mesh=mesh4)
    r_ids, r_d, _ = r_exact(ri, qs, K)
    dev = pi._device_cache[(2048, 4, CPU, mesh4)][0]
    assert dev.mesh is mesh4 and dev.n_shards == 4
    for f in ("db", "ids", "alive", "leaf_lo", "win_start", "edge_leaf"):
        parts = getattr(dev, f)
        assert isinstance(parts, tuple) and len(parts) == 4
        assert [t.device for t in parts] == list(mesh4.devices)
    for a, b in ((ids4, ids1), (d4, d1), (ids4, r_ids), (d4, r_d)):
        np.testing.assert_array_equal(a, b)
    for i, q in enumerate(qs):
        h_ids, h_d, _ = exact_search(ri, q, K)
        got = ids4[i][ids4[i] >= 0]
        assert len(np.unique(got)) == len(got)
        assert not np.isin(got, VICTIMS).any()
        np.testing.assert_array_equal(got, h_ids)
        np.testing.assert_array_equal(d4[i][:len(h_d)], h_d)
    for nbr in (1, 4):
        e1, ed1, _ = sd.extended_search_device_batch(pi, qs, K, nbr=nbr,
                                                     device=CPU)
        e4, ed4, _ = sd.extended_search_device_batch(pi, qs, K, nbr=nbr,
                                                     mesh=mesh4)
        re, red, _ = r_ext(ri, qs, K, nbr=nbr)
        for a, b in ((e4, e1), (ed4, ed1), (e4, re), (ed4, red)):
            np.testing.assert_array_equal(a, b)
        for i, q in enumerate(qs):
            h_ids, h_d, _ = extended_search(ri, q, K, nbr)
            got = e4[i][e4[i] >= 0]
            np.testing.assert_array_equal(got, h_ids)
            np.testing.assert_array_equal(ed4[i][:len(h_d)], h_d)


@pytest.mark.parametrize("metric", ["ed", "dtw"])
@pytest.mark.parametrize("nbr", [1, 4, 16])
def test_approximate_on_mesh_equals_one_shard(fuzzy, mesh4, metric, nbr):
    """The approximate path scans shard by shard on a mesh, where one
    device scans the flattened view: ids, distances and leaves bitwise."""
    _, pi = fuzzy
    qs = random_walks(8, 64, seed=12)
    dev = pi.device_index(mesh=mesh4)
    one = sd.approximate_search_device_batch(pi, qs, K, nbr=nbr,
                                             metric=metric, device=CPU)
    got = sd.approximate_search_device_batch(pi, qs, K, nbr=nbr, dev=dev,
                                             metric=metric)
    for a, b in zip(got, one):
        np.testing.assert_array_equal(a, b)


def test_bucket_on_mesh_equals_one_shard(fuzzy, mesh4):
    _, pi = fuzzy
    qs = random_walks(6, 64, seed=13)
    knobs = ([5, 3, 0, 5, 1, 2], [1, 4, 2, 16, 3, 1],
             ["ed", "dtw", "ed", "dtw", "ed", "ed"])
    one = sd.bucket_search_device_batch(pi, qs, *knobs, device=CPU)
    got = sd.bucket_search_device_batch(pi, qs, *knobs, mesh=mesh4)
    for a, b in zip(got, one):
        np.testing.assert_array_equal(a, b)
    h = (True, True, False, True)
    one = sd.bucket_search_device_batch(pi, qs, *knobs, n_shards=4,
                                        shard_health=h, device=CPU)
    got = sd.bucket_search_device_batch(pi, qs, *knobs, mesh=mesh4,
                                        shard_health=h)
    for a, b in zip(got, one):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nbr", [None, 4])
def test_degraded_search_distributed_matches_reference(fuzzy, mesh4, nbr):
    """Shard 3 dead: the coverage is the reference's, the answers are the
    reference's four-shard degraded answers and, for the exact search, a
    float64 top-k over the live shards' rows."""
    ri, pi = fuzzy
    qs = random_walks(5, 64, seed=14)
    h = (True, True, True, False)
    ids, d, cov = search_distributed(pi, qs, K, nbr=nbr, shard_health=h,
                                     mesh=mesh4)
    rdev = RDev.from_index(ri, n_shards=4)
    fn = r_exact if nbr is None else r_ext
    kw = {} if nbr is None else {"nbr": nbr}
    res = fn(ri, qs, K, dev=rdev, shard_health=h, **kw)
    assert cov == res[-1] == r_coverage(ri, rdev.with_shard_health(h))
    assert 0.0 < cov < 1.0
    np.testing.assert_array_equal(ids, res[0])
    np.testing.assert_array_equal(d, res[1])
    if nbr is None:
        dev = pi.device_index(mesh=mesh4)
        rb = dev.row_bounds
        live = np.unique(pi.flat.order[rb[0]:rb[3]])
        live = live[pi.alive[live]]
        x = pi.db[live].astype(np.float64)
        for i, q in enumerate(qs):
            dd = np.sqrt(((x - q.astype(np.float64)) ** 2).sum(1))
            o = np.lexsort((live, dd))[:K]
            np.testing.assert_array_equal(ids[i], live[o])
            np.testing.assert_allclose(d[i], dd[o], rtol=1e-5)


def test_mesh_placement_keeps_tombstones_current(mesh4):
    """A delete after placement refreshes the placed ``alive`` shards
    without a new layout, each shard on its own mesh entry."""
    _, pi = build_pair(random_walks(900, 64, seed=8), th=64)
    qs = random_walks(4, 64, seed=15)
    before = sd.exact_search_device_batch(pi, qs, K, mesh=mesh4)
    victim = int(before[0][0, 0])
    builds = pi._n_device_builds
    pi.delete(victim)
    got = sd.exact_search_device_batch(pi, qs, K, mesh=mesh4)
    assert pi._n_device_builds == builds
    one = sd.exact_search_device_batch(pi, qs, K, device=CPU)
    assert victim not in got[0]
    np.testing.assert_array_equal(got[0], one[0])
    np.testing.assert_array_equal(got[1], one[1])
    dev = pi.device_index(mesh=mesh4)
    assert isinstance(dev.alive, tuple) and len(dev.alive) == 4
    assert [t.device for t in dev.alive] == list(mesh4.devices)


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------

def test_use_mesh_sets_the_current_mesh(fuzzy, mesh4):
    _, pi = fuzzy
    qs = random_walks(3, 64, seed=16)
    assert get_mesh() is None
    with use_mesh(mesh4):
        assert get_mesh() is mesh4
        ids, d = search_distributed(pi, qs, K)
        with use_mesh(None):
            assert get_mesh() is None
        assert get_mesh() is mesh4
    assert get_mesh() is None
    assert (2048, 4, CPU, mesh4) in pi._device_cache
    one = sd.exact_search_device_batch(pi, qs, K, device=CPU)
    np.testing.assert_array_equal(ids, one[0])
    np.testing.assert_array_equal(d, one[1])


def test_mesh_entry_points_need_cuda_or_an_explicit_cpu(fuzzy, mesh4):
    """Without a GPU, nothing runs on the CPU unless asked to."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    _, pi = fuzzy
    qs = random_walks(2, 64, seed=17)
    for call in (lambda: make_mesh(["cuda"]),
                 lambda: make_mesh([CPU, "cuda:0"]),
                 lambda: build_distributed(random_walks(50, 64, seed=1)),
                 lambda: search_distributed(pi, qs, K),
                 lambda: search_distributed(pi, qs, K, nbr=2),
                 lambda: pi.device_index(n_shards=4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(ValueError, match="mesh of 4 devices"):
        pi.device_index(n_shards=3, mesh=mesh4)
    with pytest.raises(ValueError, match="a mesh of 4 devices for 2"):
        pi.device_index(n_shards=2, device=CPU).shard(mesh4)
    assert make_mesh([CPU, "cpu"]).distinct == (torch.device(CPU),)


# ---------------------------------------------------------------------------
# the shards' loops driven at once (search_device._drive)
# ---------------------------------------------------------------------------

#: span widths: ~60 spans a shard for ED, ~16 for DTW: several stop tests
CHUNK = {"ed": 16, "dtw": 64}
BAND = 6
METRICS = [("ed", None), ("dtw", "shared"), ("dtw", "perq"),
           ("dtw", "cluster")]
COUNTERS = sd.STAT_KEYS + ("dp_survivors",)


@pytest.fixture(scope="module")
def wide():
    """4000 x 64, fuzzy, tombstoned: ~1000 rows a shard of four."""
    ri, pi = build_pair(random_walks(4000, 64, seed=21), th=64,
                        fuzzy_f=0.1)
    for v in VICTIMS:
        ri.delete(v)
        pi.delete(v)
    return ri, pi


@pytest.mark.parametrize("metric,order", METRICS)
def test_interleaved_mesh_equals_reference(wide, mesh4, metric, order):
    """The four shards' loops driven at once on the four-entry mesh: ids
    and distances bitwise the reference's ``search_distributed``, and with
    the spans (or chunks) visited and the cascade counters, bitwise the
    reference's four-shard batch; the host syncs equal the sum of the
    shards' reads when each loop is driven alone."""
    ri, pi = wide
    qs = random_walks(8, 64, seed=22)
    kw = dict(metric=metric, band=BAND if metric == "dtw" else None)
    chunk = CHUNK[metric]
    got = sd.exact_search_device_batch(pi, qs, K, chunk=chunk, mesh=mesh4,
                                       order=order, return_stats=True, **kw)
    want = r_exact(ri, qs, K, dev=RDev.from_index(ri, chunk=chunk,
                                                  n_shards=4),
                   order=order, return_stats=True, **kw)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert {c: got[3][c] for c in COUNTERS} == want[3]
    r_ids, r_d = r_search_dist(ri, qs, K, **kw)
    np.testing.assert_array_equal(got[0], r_ids)
    np.testing.assert_array_equal(got[1], r_d)
    dev = pi.device_index(chunk=chunk, mesh=mesh4)
    met = resolve(metric, 64, kw["band"], order)
    prep, _ = sd._prep_batch(met, torch.from_numpy(qs), 8, 8)
    knn = sd._shard_knn if order in (None, "shared") else sd._lane_knn
    kk = sd._result_margin(dev, K) + 8
    alone = [sd._drive([knn(dev, s, prep, torch.from_numpy(qs), kk, met)])
             for s in range(4)]
    assert got[3]["host_syncs"] == sum(r for _, (r,) in alone)


def _record_steps(monkeypatch, dev, name, db_arg):
    """Wrap ``search_device.<name>`` (``_span_step`` or ``_walk_step``):
    every call appends the shard whose rows it reads."""
    shard_of = {dev.db[s].data_ptr(): s for s in range(dev.n_shards)}
    calls, real = [], getattr(sd, name)

    def step(*a):
        calls.append(shard_of[db_arg(a).data_ptr()])
        return real(*a)

    monkeypatch.setattr(sd, name, step)
    return calls


@pytest.mark.parametrize("metric,order", [("ed", None), ("dtw", "shared"),
                                          ("dtw", "perq")])
def test_a_stopped_shard_gets_no_further_step(wide, mesh4, monkeypatch,
                                              metric, order):
    """With a stop test every 2 steps (and 16-lane walk chunks), the
    shards' steps interleave, every shard takes exactly the steps it takes
    driven alone, a shard whose stop test fired before its last span (or
    chunk) takes no further step, and the reads are one a stop test (and
    one for each span schedule)."""
    _, pi = wide
    monkeypatch.setattr(sd, "STOP_CHECK_EVERY", 2)
    monkeypatch.setattr(sd, "DTW_LANE_CHUNK", 16)
    qs = torch.from_numpy(random_walks(6, 64, seed=23))
    dev = pi.device_index(chunk=CHUNK[metric], mesh=mesh4)
    met = resolve(metric, 64, BAND if metric == "dtw" else None, order)
    prep, _ = sd._prep_batch(met, qs, 8, 8)
    lanes = order == "perq"
    knn = sd._lane_knn if lanes else sd._shard_knn
    calls = _record_steps(
        monkeypatch, dev, "_walk_step" if lanes else "_span_step",
        (lambda a: a[0]) if lanes else (lambda a: a[3][0]))
    parts, reads = sd._drive([knn(dev, s, prep, qs, K, met)
                              for s in range(4)])
    together = list(calls)
    steps = [together.count(s) for s in range(4)]
    total = [-(-(dev.shard_rows - K) // 16) if lanes
             else dev.win_start[s].shape[0] for s in range(4)]
    assert any(n < t for n, t in zip(steps, total))    # a stop test fired
    # interleaved: shard 1 steps before shard 0 takes its last step
    assert together.index(1) < len(together) - together[::-1].index(0) - 1
    for s in range(4):
        calls.clear()
        (part,), (r,) = sd._drive([knn(dev, s, prep, qs, K, met)])
        assert calls == [s] * steps[s]
        for a, b in zip(part, parts[s]):
            assert torch.equal(a, b)
        tests = (steps[s] // 2 + 1 if steps[s] < total[s]
                 else -(-total[s] // 2))
        assert reads[s] == r == tests + (0 if lanes else 1)


def test_encode_distributed_launches_every_shard_before_a_gather(
        monkeypatch):
    events = []
    real_step, real_host = D.build_step, D._to_host

    def step(x, w, b):
        events.append("launch")
        return real_step(x, w, b)

    def host(t):
        events.append("gather")
        return real_host(t)

    monkeypatch.setattr(D, "build_step", step)
    monkeypatch.setattr(D, "_to_host", host)
    db = random_walks(1003, 64, seed=24)
    paa, sax, hist = encode_distributed(db, 8, 8,
                                        mesh=make_mesh([CPU] * 4))
    assert events == ["launch"] * 4 + ["gather"] * 8
    one = encode_distributed(db, 8, 8, mesh=make_mesh([CPU]))
    for a, b in zip((paa, sax, hist), one):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
