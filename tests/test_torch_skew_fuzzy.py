"""The skewed collection (paper §5.1's node-imbalance regime) and
Dumpy-Fuzzy (§6) in the port, against the reference, on the CPU
(``device="cpu"``).

* ``repro_torch.data.series.clustered_series`` and ``random_walks``
  bitwise the reference's, across their chunk boundaries, and
  ``cluster_assignment`` the first draw;
* the host encoder (``sax.sax_encode_np``, in threaded row chunks) and the
  split-plan search (``split.choose_split_plan``, which marginalizes the
  occupied codes alone and scores plans in batches) bitwise the
  reference's;
* on the port's skewed collection, plain Dumpy and Dumpy-Fuzzy
  (``fuzzy_f`` 0.1, ``max_replica`` 3): the tree, ``flat``, ``stats``,
  ``FlatLeaves.leaf_slice`` and ``FlatRouting.n_nodes`` equal to the
  reference's, and ``backend="device"`` bitwise the host build;
* exact ED and DTW, approximate and extended search at nbr 1, 4, 16 and
  one mixed bucket against the reference's device paths;
* ``delete``: no replica of a deleted id comes back on any path;
* ``DeviceIndex.n_live_shards`` against the reference's.

Tolerances.  Layouts, exact answers, extended answers after the host
re-rank (``rerank=True``) and every leaf schedule are compared bitwise.
The approximate path and the bucket return each package's own float32
sums (no host re-rank), so there distances agree within rtol 1e-5 and ids
only move between tied distances (``assert_ties_only``), as in
``test_torch_approx_search.py`` and ``test_torch_serving_batching.py``."""
import dataclasses
import itertools

import numpy as np
import pytest

from _torch_port import (assert_ties_only, params_pair,  # noqa: F401
                         torch_threads)
from repro.core import search as rs
from repro.core import search_device as rsd
from repro.core import sax as r_sax
from repro.core import split as r_split
from repro.core.device_index import DeviceIndex as RDev
from repro.core.index import DumpyIndex as RIndex
from repro.core.index import _tree_to_json as r_tree_json
from repro.data import series as r_series
from repro_torch.core import search as ps
from repro_torch.core import search_device as sd
from repro_torch.core import sax as p_sax
from repro_torch.core import split as p_split
from repro_torch.core.index import DumpyIndex
from repro_torch.core.index import _tree_to_json
from repro_torch.core.sax import ENCODE_ROWS
from repro_torch.data import series

CPU = "cpu"
K = 10
BAND = 6
N, LEN = 3000, 64
LAYOUTS = ("plain", "fuzzy")
VICTIMS_N = 40


# -- the generator --------------------------------------------------------------

GEN_CASES = [
    # (n, length, n_clusters, noise, seed, CHUNK_ROWS)
    (1000, 37, 8, 0.25, 1, 333),        # chunks of 333: three boundaries
    (6000, 64, 64, 0.25, 1, 1 << 16),   # one chunk
    (6000, 64, 64, 0.1, 7, 1000),
    (5000, 16, 8, 0.5, 3, 4999),        # one row past the boundary
    (70_000, 4, 64, 0.25, 1, 1 << 16),  # past the default chunk
    (3, 5, 64, 0.25, 2, 1),             # a row a chunk; most clusters empty
    (0, 8, 8, 0.25, 1, 1 << 16),
]


@pytest.mark.parametrize("n,length,n_clusters,noise,seed,chunk", GEN_CASES)
def test_clustered_series_bitwise_reference(n, length, n_clusters, noise,
                                            seed, chunk, monkeypatch):
    want = r_series.clustered_series(n, length, n_clusters=n_clusters,
                                     noise=noise, seed=seed)
    monkeypatch.setattr(series, "CHUNK_ROWS", chunk)
    got = series.clustered_series(n, length, n_clusters=n_clusters,
                                  noise=noise, seed=seed)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (n, length)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n,length,seed,chunk", [
    (1000, 37, 0, 333), (5000, 64, 3, 4999), (70_000, 5, 1, 1 << 16),
    (7, 256, 10_007, 2), (0, 8, 0, 1 << 16)])
def test_random_walks_bitwise_reference(n, length, seed, chunk,
                                        monkeypatch):
    """The Rand generator in chunks (float32 draws of odd row lengths
    included) gives the reference's rows bit for bit."""
    want = r_series.random_walks(n, length, seed=seed)
    monkeypatch.setattr(series, "CHUNK_ROWS", chunk)
    got = series.random_walks(n, length, seed=seed)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n_clusters", [8, 64])
def test_cluster_assignment_is_the_generators_draw(n_clusters):
    """Without noise every row is its centroid, z-normalized: two rows are
    equal exactly where ``cluster_assignment`` puts them in one cluster;
    the shares fall with the cluster's rank (zipf-ish)."""
    n = 4000
    x = series.clustered_series(n, 32, n_clusters=n_clusters, noise=0.0,
                                seed=5)
    a = series.cluster_assignment(n, n_clusters, seed=5)
    assert a.shape == (n,) and a.min() >= 0 and a.max() < n_clusters
    first = {}
    for i, c in enumerate(a):
        first.setdefault(int(c), i)
    reps = x[[first[int(c)] for c in a]]
    np.testing.assert_array_equal(x, reps)
    uniq, inv = np.unique(x, axis=0, return_inverse=True)
    assert len(uniq) == len(first)
    sizes = np.bincount(a, minlength=n_clusters)
    assert sizes[0] == sizes.max() and sizes[0] > 2 * sizes[-1]


@pytest.mark.parametrize("rows,n,w", [(ENCODE_ROWS + 1, 64, 16),
                                      (2 * ENCODE_ROWS + 77, 32, 8),
                                      (ENCODE_ROWS, 64, 4), (5, 64, 16)])
def test_sax_encode_np_chunks_bitwise_reference(rows, n, w):
    """The host encoder's threaded row chunks (past ``ENCODE_ROWS`` rows)
    give the reference's PAA and symbols bit for bit."""
    x = series.clustered_series(rows, n, n_clusters=64, seed=2)
    want = r_sax.sax_encode_np(x, r_sax.SaxParams(w=w, b=8))
    got = p_sax.sax_encode_np(x, p_sax.SaxParams(w=w, b=8))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# -- the split-plan search --------------------------------------------------------

SPLIT_CASES = ([(m, dens, c_n, seed) for m in (3, 8, 12)
                for dens, c_n in ((0.002, 50_000), (0.05, 400_000),
                                  (1.0, 2_000_000))
                for seed in (0, 1)]
               + [(16, 0.002, 50_000, seed) for seed in (0, 1)])


@pytest.mark.parametrize("m,dens,c_n,seed", SPLIT_CASES)
def test_choose_split_plan_bitwise_reference(m, dens, c_n, seed):
    """Sparse and dense next-bit histograms (a skewed node's ``2**16``
    histogram is mostly empty): the chosen plan equals the reference's, and
    every marginal equals a dense reshape-and-sum."""
    rng = np.random.default_rng(seed)
    hist = ((rng.random(1 << m) < dens)
            * rng.integers(1, 10_000, 1 << m)).astype(np.int64)
    hist[rng.integers(0, 1 << m)] += 1            # never all empty
    seg_vars = rng.random(m)
    cand = sorted(rng.choice(16, m, replace=False).tolist())
    want = r_split.choose_split_plan(hist, seg_vars, cand, c_n,
                                     r_split.SplitParams(th=10_000))
    got = p_split.choose_split_plan(hist, seg_vars, cand, c_n,
                                    p_split.SplitParams(th=10_000))
    assert got == want
    for lam in (1, max(m // 2, 1), m):
        for keep in itertools.islice(itertools.combinations(range(m), lam),
                                     20):
            drop = tuple(i for i in range(m) if i not in keep)
            dense = (hist.reshape((2,) * m).sum(axis=drop).reshape(-1)
                     if drop else hist)
            got_h = p_split._marginalize(hist, m, keep)
            assert got_h.dtype == dense.dtype
            np.testing.assert_array_equal(got_h, dense)


# -- the indexes ---------------------------------------------------------------------

def _params(layout: str):
    """``(reference, port)`` parameters: paper widths cut to 64, th 128;
    Dumpy-Fuzzy at the reference benchmark's fuzzy_f 0.1, max_replica 3."""
    fz = 0.1 if layout == "fuzzy" else 0.0
    rp, pp = params_pair(w=8, b=8, th=128, fuzzy_f=fz)
    return (dataclasses.replace(rp, max_replica=3),
            dataclasses.replace(pp, max_replica=3))


@pytest.fixture(scope="module")
def skew():
    return series.clustered_series(N, LEN, n_clusters=64, seed=1)


@pytest.fixture(scope="module")
def pairs(skew):
    """``{layout: (reference index, port index)}`` over the port's skewed
    collection."""
    out = {}
    for layout in LAYOUTS:
        rp, pp = _params(layout)
        out[layout] = (RIndex.build(skew, rp), DumpyIndex.build(skew, pp))
    assert out["fuzzy"][1].stats.n_duplicates > 0
    return out


@pytest.fixture(scope="module")
def queries():
    return series.query_workload(8, LEN, seed=41)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_build_equals_reference(pairs, layout):
    ri, pi = pairs[layout]
    assert _tree_to_json(pi.root) == r_tree_json(ri.root)
    for f in ("leaf_sym", "leaf_card", "leaf_lo", "leaf_hi", "leaf_offsets",
              "order"):
        a, b = getattr(pi.flat, f), getattr(ri.flat, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert dataclasses.asdict(pi.stats) == dataclasses.asdict(ri.stats)
    assert pi.flat.n_leaves == ri.flat.n_leaves
    for leaf in range(pi.flat.n_leaves):
        np.testing.assert_array_equal(pi.flat.leaf_slice(leaf),
                                      ri.flat.leaf_slice(leaf))
    assert pi.routing_flat.n_nodes == ri.routing_flat.n_nodes > 1
    assert (len(pi.flat.order) > N) == (layout == "fuzzy")   # replicas


@pytest.mark.parametrize("layout", LAYOUTS)
def test_device_backend_bitwise_host(pairs, skew, layout):
    _, pi = pairs[layout]
    _, pp = _params(layout)
    dv = DumpyIndex.build(skew, pp, backend="device", device=CPU)
    assert _tree_to_json(dv.root) == _tree_to_json(pi.root)
    for f in ("leaf_sym", "leaf_card", "leaf_lo", "leaf_hi", "leaf_offsets",
              "order"):
        np.testing.assert_array_equal(getattr(dv.flat, f),
                                      getattr(pi.flat, f), err_msg=f)
    a, b = dataclasses.asdict(dv.stats), dataclasses.asdict(pi.stats)
    a.pop("plans_evaluated")
    b.pop("plans_evaluated")
    assert a == b
    assert dv.routing_flat.n_nodes == pi.routing_flat.n_nodes


# -- search ---------------------------------------------------------------------------

def _delete(pair, victims):
    ri, pi = pair
    for v in victims:
        ri.delete(int(v))
        pi.delete(int(v))


@pytest.fixture(scope="module")
def tombstoned(skew, queries):
    """Fresh plain and fuzzy pairs with ``VICTIMS_N`` ids deleted: the
    fuzzy layout's replicated ids that its exact answers hold first."""
    out = {}
    for layout in LAYOUTS:
        rp, pp = _params(layout)
        out[layout] = (RIndex.build(skew, rp), DumpyIndex.build(skew, pp))
    pi = out["fuzzy"][1]
    ids, _, _ = sd.exact_search_device_batch(pi, queries, K, device=CPU)
    copies = np.bincount(pi.flat.order, minlength=N)
    first = [int(i) for i in dict.fromkeys(ids.ravel()) if copies[i] > 1]
    rest = [int(i) for i in np.flatnonzero(copies > 1) if i not in first]
    victims = np.array((first + rest)[:VICTIMS_N], np.int64)
    assert len(victims) == VICTIMS_N and (copies[victims] > 1).all()
    for pair in out.values():
        _delete(pair, victims)
    return out, victims


def _pair(request, layout, dead):
    if dead:
        out, victims = request.getfixturevalue("tombstoned")
        return out[layout], victims
    return request.getfixturevalue("pairs")[layout], np.empty(0, np.int64)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dead", [False, True])
def test_exact_ed_bitwise_reference(request, queries, layout, dead):
    (ri, pi), victims = _pair(request, layout, dead)
    ids, d, vis = sd.exact_search_device_batch(pi, queries, K, chunk=256,
                                               device=CPU)
    r_ids, r_d, r_vis = rsd.exact_search_device_batch(
        ri, queries, K, dev=RDev.from_index(ri, chunk=256))
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_array_equal(d, r_d)
    np.testing.assert_array_equal(vis, r_vis)
    assert not np.isin(ids, victims).any()
    for row in ids:
        assert len(np.unique(row[row >= 0])) == K
    for i, q in enumerate(queries[:3]):
        h_ids, h_d, _ = ps.exact_search(pi, q, K)
        np.testing.assert_array_equal(ids[i], h_ids)
        np.testing.assert_array_equal(d[i], h_d)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dead", [False, True])
def test_exact_dtw_bitwise_reference(request, queries, layout, dead):
    """Order ``cluster`` (the smoke's): ids, distances, chunks visited and
    the cascade counters of the reference's batch."""
    (ri, pi), victims = _pair(request, layout, dead)
    qs = queries[:4]
    got = sd.exact_search_device_batch(pi, qs, K, metric="dtw", band=BAND,
                                       order="cluster", return_stats=True,
                                       device=CPU)
    want = rsd.exact_search_device_batch(
        ri, qs, K, dev=RDev.from_index(ri), metric="dtw", band=BAND,
        order="cluster", return_stats=True)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert {c: got[3][c] for c in want[3]} == want[3]
    assert not np.isin(got[0], victims).any()
    for row in got[0]:
        assert len(np.unique(row[row >= 0])) == K


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("metric", ["ed", "dtw"])
@pytest.mark.parametrize("nbr", [1, 4, 16])
def test_approximate_and_extended_reference(request, queries, layout,
                                            metric, nbr):
    """Approximate: schedules bitwise, answers by the tie rule; extended
    (re-ranked): bitwise the reference's, and (ED) each query the host
    ``extended_search``'s; tombstoned replicas never returned."""
    for dead in (False, True):
        (ri, pi), victims = _pair(request, layout, dead)
        qs = queries if metric == "ed" else queries[:3]
        ids, d, lv = sd.approximate_search_device_batch(
            pi, qs, K, nbr=nbr, metric=metric, band=BAND, device=CPU)
        r_ids, r_d, r_lv = rsd.approximate_search_device_batch(
            ri, qs, K, nbr=nbr, metric=metric, band=BAND)
        np.testing.assert_array_equal(lv, r_lv)
        assert_ties_only(ids, d, np.asarray(r_ids), np.asarray(r_d))
        assert not np.isin(ids, victims).any()
        got = sd.extended_search_device_batch(pi, qs, K, nbr=nbr,
                                              metric=metric, band=BAND,
                                              device=CPU)
        want = rsd.extended_search_device_batch(ri, qs, K, nbr=nbr,
                                                metric=metric, band=BAND)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert not np.isin(got[0], victims).any()
        if metric == "ed":
            for i, q in enumerate(qs):
                h_ids, h_d, _ = ps.extended_search(pi, q, K, nbr)
                m = len(h_ids)
                np.testing.assert_array_equal(got[0][i, :m], h_ids)
                np.testing.assert_array_equal(got[1][i, :m], h_d)
        if nbr == 1 and metric == "ed":
            for i, q in enumerate(qs):
                paa, sax = ps._encode_query(pi, q)
                assert lv[i, 0] == ps.route_to_leaf(pi, paa, sax).leaf_id
                h_ids, h_d, _ = ps.approximate_search(pi, q, K)
                r_h = rs.approximate_search(ri, q, K)
                np.testing.assert_array_equal(h_ids, r_h[0])
                np.testing.assert_array_equal(h_d, r_h[1])
                m = len(h_ids)
                assert_ties_only(ids[i:i + 1, :m], d[i:i + 1, :m],
                                 h_ids[None], h_d[None])


BUCKET = dict(ks=[4, 0, 10, 6, 1, 8, 10, 3], nbrs=[2, 0, 4, 3, 1, 4, 2, 1],
              mets=["ed", "ed", "ed", "dtw", "ed", "ed", "ed", "dtw"])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dead", [False, True])
def test_mixed_bucket_reference_and_lanes(request, queries, layout, dead):
    """One 8-lane bucket, 25% DTW, lane 1 dead: schedules bitwise the
    reference's bucket, answers by the tie rule; each live lane bitwise
    the same request alone."""
    (ri, pi), victims = _pair(request, layout, dead)
    qs = queries.copy()
    qs[1] = 0.0
    args = (qs, BUCKET["ks"], BUCKET["nbrs"], BUCKET["mets"])
    kw = dict(k_max=10, nbr_max=4, band=BAND)
    ids, d, leaves = sd.bucket_search_device_batch(pi, *args, device=CPU,
                                                   **kw)
    want = rsd.bucket_search_device_batch(ri, *args, **kw)
    np.testing.assert_array_equal(leaves, np.asarray(want[2]))
    assert_ties_only(ids, d, np.asarray(want[0]), np.asarray(want[1]))
    assert not np.isin(ids, victims).any()
    for i, (k, nbr, m) in enumerate(zip(*args[1:])):
        if k == 0:
            assert (ids[i] == -1).all() and np.isinf(d[i]).all()
            continue
        a = sd.extended_search_device_batch(pi, qs[i:i + 1], k, nbr=nbr,
                                            metric=m, band=BAND,
                                            rerank=False, device=CPU)
        np.testing.assert_array_equal(ids[i, :k], a[0][0])
        np.testing.assert_array_equal(d[i, :k], a[1][0])
        np.testing.assert_array_equal(leaves[i, :nbr], a[2][0][:nbr])


def test_delete_kills_every_replica(tombstoned):
    """Each deleted id's every row is dead in the ``DeviceIndex``, as in
    the reference's; the live rows are those of the live ids."""
    out, victims = tombstoned
    ri, pi = out["fuzzy"]
    dv = pi.device_index(device=CPU)
    rdv = RDev.from_index(ri)
    ids = dv.ids[0].numpy()
    alive = dv.alive[0].numpy()
    hit = np.isin(ids, victims)
    assert hit.sum() == np.bincount(pi.flat.order, minlength=N)[victims].sum()
    assert hit.sum() > len(victims)
    assert not alive[hit].any()
    assert alive[(ids >= 0) & ~hit].all()
    np.testing.assert_array_equal(alive, np.asarray(rdv.alive[0]))
    np.testing.assert_array_equal(ids, np.asarray(rdv.ids[0]))


@pytest.mark.parametrize("health", [None, (True, False, True, True),
                                    (False, True, False, True),
                                    (True, True, True, False)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_n_live_shards_reference(pairs, layout, health):
    ri, pi = pairs[layout]
    dv = pi.device_index(n_shards=4, device=CPU).with_shard_health(health)
    rdv = RDev.from_index(ri, n_shards=4).with_shard_health(health)
    assert dv.n_shards == rdv.n_shards == 4
    assert dv.n_live_shards == rdv.n_live_shards
    assert dv.n_live_shards == (4 if health is None else sum(health))


# -- the smoke run's float64 checks -----------------------------------------------

def _smoke():
    """``chip_smoke.py`` as a module (its checks run on any device)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_checks", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scheduled", [False, True])
def test_smoke_float64_dtw_check_is_exact(scheduled):
    """The smoke's float64 DTW check (LB_Keogh, then LB_Improved, then a
    DP that drops a pair once its partial cost passes the bound) gives the
    top-k of the host DP over every row, or over each query's own rows."""
    import torch
    from types import SimpleNamespace
    from repro_torch.core.lb import dtw_np
    cs = _smoke()
    n, r, k = 1200, 4, 5
    x = series.clustered_series(n, 32, n_clusters=8, seed=4)
    qs = series.query_workload(3, 32, seed=5)
    rng = np.random.default_rng(6)
    sel = [np.sort(rng.choice(n, 400, replace=False)) if scheduled
           else np.arange(n) for _ in qs]
    full = [np.array([dtw_np(q, x[j], r) for j in s]) for q, s in zip(qs, sel)]
    order = [np.argsort(f, kind="stable")[:k + 1] for f in full]
    d_port = np.stack([f[o[:k]] for f, o in zip(full, order)]
                      ).astype(np.float32)
    dev = SimpleNamespace(db=[torch.from_numpy(x)],
                          ids=[torch.arange(n, dtype=torch.int32)],
                          alive=[torch.ones(n, dtype=torch.bool)])
    rows_of = (lambda qi: torch.from_numpy(sel[qi])) if scheduled else None
    bd, bi, n_dp = cs.dtw_float64_check(torch, dev, torch.from_numpy(qs),
                                        d_port, r, k, rows_of)
    assert 0 < n_dp < sum(len(s) for s in sel)
    for qi, (f, o, s) in enumerate(zip(full, order, sel)):
        # dtw_np rounds each cell's cost to float32 first, the check
        # keeps it in float64
        np.testing.assert_allclose(bd[qi, :k].numpy(), f[o[:k]], rtol=1e-6)
        np.testing.assert_array_equal(bi[qi, :k].numpy(), s[o[:k]])


def test_smoke_schedule_rows_keep_each_id_once(pairs):
    """On a fuzzy layout the smoke's ``rows_of`` gives one row of each id
    in the scheduled leaves (a top-k counts an id once); on a plain layout
    every row."""
    import torch
    cs = _smoke()
    for layout in LAYOUTS:
        _, pi = pairs[layout]
        dv = pi.device_index(device=CPU)
        leaves = np.array([[0, 3, 5], [2, 4, -1]])
        rows_of = cs.schedule_rows(torch, np, dv, leaves)
        ids = dv.ids[0].numpy()
        for qi in range(2):
            rows = rows_of(qi).numpy()
            want = np.unique(np.concatenate(
                [pi.flat.leaf_slice(lf) for lf in leaves[qi] if lf >= 0]))
            np.testing.assert_array_equal(np.sort(ids[rows]), want)
            assert (len(rows) == len(want)) or layout == "plain"
