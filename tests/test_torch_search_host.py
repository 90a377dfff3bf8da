"""The port's host search (``repro_torch.core.search``) against the
reference's ``repro.core.search``: ``approximate_search``,
``extended_search``, ``route_to_leaf`` and ``exact_search`` give bitwise the
same ids, distances and visit counts, under ED and DTW, on plain and fuzzy
layouts with tombstones; ``average_precision`` and ``error_ratio`` give the
same floats.  Tolerance: none, every comparison is exact."""
import dataclasses

import numpy as np
import pytest

from _torch_port import build_pair, torch_threads  # noqa: F401
from repro.core import search as rs
from repro.data.series import random_walks
from repro_torch.core import search as ps

K = 10
BAND = 6
VICTIMS = (5, 17, 300, 1111)


def _tombstone(ri, pi):
    for v in VICTIMS:
        ri.delete(v)
        pi.delete(v)
    return ri, pi


@pytest.fixture(scope="module")
def plain():
    return _tombstone(*build_pair(random_walks(4000, 64, seed=0)))


@pytest.fixture(scope="module")
def fuzzy():
    ri, pi = build_pair(random_walks(2500, 64, seed=2), fuzzy_f=0.15)
    assert pi.stats.n_duplicates > 0
    return _tombstone(ri, pi)


def _assert_same(got, want):
    """(ids, d, stats) of one query: bitwise, dtypes included."""
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    assert dataclasses.astuple(got[2]) == dataclasses.astuple(want[2])


@pytest.mark.parametrize("layout", ["plain", "fuzzy"])
@pytest.mark.parametrize("metric", ["ed", "dtw"])
def test_approximate_search_bitwise(layout, metric, request):
    ri, pi = request.getfixturevalue(layout)
    n_q = 12 if metric == "ed" else 3
    for q in random_walks(n_q, 64, seed=91):
        got = ps.approximate_search(pi, q, K, metric=metric, band=BAND)
        want = rs.approximate_search(ri, q, K, metric=metric, band=BAND)
        _assert_same(got, want)
        assert not np.isin(got[0], VICTIMS).any()


@pytest.mark.parametrize("layout", ["plain", "fuzzy"])
def test_extended_search_bitwise_ed(layout, request):
    ri, pi = request.getfixturevalue(layout)
    qs = random_walks(6, 64, seed=13)
    for nbr in (1, 2, 4, 8, pi.flat.n_leaves + 5):
        for q in qs:
            got = ps.extended_search(pi, q, K, nbr)
            _assert_same(got, rs.extended_search(ri, q, K, nbr))
            ids = got[0]
            assert len(np.unique(ids)) == len(ids)       # fuzzy dedup


@pytest.mark.parametrize("layout", ["plain", "fuzzy"])
def test_extended_search_bitwise_dtw(layout, request):
    ri, pi = request.getfixturevalue(layout)
    q = random_walks(1, 64, seed=29)[0]
    for nbr in (1, 2, 4):
        got = ps.extended_search(pi, q, K, nbr, metric="dtw", band=BAND)
        want = rs.extended_search(ri, q, K, nbr, metric="dtw", band=BAND)
        _assert_same(got, want)


@pytest.mark.parametrize("scale", ["in_distribution", "adversarial"])
@pytest.mark.parametrize("metric", ["ed", "dtw"])
def test_route_to_leaf_same_leaf(plain, scale, metric):
    """Adversarial queries (``4·walk + 3``, far outside the data) hit empty
    routing regions and take the min-bound fallback child."""
    ri, pi = plain
    qs = random_walks(16, 64, seed=101)
    if scale == "adversarial":
        qs = 4.0 * qs + 3.0
    for q in qs:
        paa, sax = ps._encode_query(pi, q)
        r_paa, r_sax = rs._encode_query(ri, q)
        np.testing.assert_array_equal(paa, r_paa)
        np.testing.assert_array_equal(sax, r_sax)
        met = ps.resolve(metric, 64, BAND)
        seg = ps.query_prep_np(met, q, paa)[:2]
        got = ps.route_to_leaf(pi, paa, sax, qseg=seg)
        want = rs.route_to_leaf(ri, r_paa, r_sax, qseg=seg)
        assert got.leaf_id == want.leaf_id


@pytest.mark.parametrize("layout", ["plain", "fuzzy"])
@pytest.mark.parametrize("metric", ["ed", "dtw"])
def test_exact_search_bitwise(layout, metric, request):
    ri, pi = request.getfixturevalue(layout)
    n_q = 6 if metric == "ed" else 1
    for q in random_walks(n_q, 64, seed=31):
        got = ps.exact_search(pi, q, K, metric=metric, band=BAND)
        want = rs.exact_search(ri, q, K, metric=metric, band=BAND)
        _assert_same(got, want)


def test_degenerate_and_empty_index():
    """A one-leaf tree (the root is the leaf) and an empty index: the same
    answers, the empty index returning nothing."""
    ri, pi = build_pair(random_walks(50, 64, seed=3))
    assert pi.root.is_leaf
    q = random_walks(1, 64, seed=4)[0]
    for fn in ("approximate_search", "exact_search"):
        _assert_same(getattr(ps, fn)(pi, q, K), getattr(rs, fn)(ri, q, K))
    for nbr in (1, 3):
        _assert_same(ps.extended_search(pi, q, K, nbr),
                     rs.extended_search(ri, q, K, nbr))
    ri, pi = build_pair(np.zeros((0, 64), np.float32))
    got = ps.extended_search(pi, q, 5, 4)
    _assert_same(got, rs.extended_search(ri, q, 5, 4))
    assert len(got[0]) == 0


def test_measures_equal_reference():
    rng = np.random.default_rng(5)
    for _ in range(20):
        exact_ids = rng.choice(50, K, replace=False)
        approx_ids = rng.choice(50, rng.integers(0, K + 1), replace=False)
        assert ps.average_precision(approx_ids, exact_ids) == \
            rs.average_precision(approx_ids, exact_ids)
        exact_d = np.sort(rng.random(K).astype(np.float32))
        exact_d[:rng.integers(0, 3)] = 0.0          # zero-distance guard
        approx_d = np.sort(rng.random(rng.integers(0, K + 1))
                           ).astype(np.float32)
        assert ps.error_ratio(approx_d, exact_d) == \
            rs.error_ratio(approx_d, exact_d)
