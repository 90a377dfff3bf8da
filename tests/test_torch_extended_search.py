"""The port's batched extended search (paper Alg. 4,
``extended_search_device_batch``) against the reference's and against the
host ``extended_search`` of both packages (twins of
``tests/test_extended_search.py``), on the CPU (``device="cpu"``); plus
``FlatRouting.stop_span_cap``, the reference's schedule-window width,
which the port keeps as a routing property.

Tolerances.  Leaf schedules, and ids and distances after the host re-rank
(``rerank=True``), are compared bitwise.  With ``rerank=False`` each
package returns its own float32 sums: distances within rtol 1e-5, ids
equal except between distances tied within that rtol
(``assert_ties_only``)."""
import numpy as np
import pytest

from _torch_port import (assert_ties_only, build_pair,
                         torch_threads)  # noqa: F401
from repro.core import search as rs
from repro.core.device_index import DeviceIndex as RDev
from repro.core.index import FlatRouting as RFlatRouting
from repro.core.search_device import extended_search_device_batch as r_ext
from repro.core.search_device import lane_finite_error as r_lane_error
from repro.data.series import random_walks
from repro_torch.core import search as ps
from repro_torch.core.index import FlatRouting
from repro_torch.core.search_device import (exact_search_device_batch,
                                            extended_search_device_batch,
                                            lane_finite_error)

CPU = "cpu"
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


def _ext(pi, qs, nbr, **kw):
    return extended_search_device_batch(pi, qs, K, nbr=nbr, device=CPU, **kw)


def _assert_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["plain", "fuzzy"])
@pytest.mark.parametrize("metric", ["ed", "dtw"])
def test_rerank_bitwise_equals_reference_and_hosts(layout, metric, request):
    """``rerank=True``: ids, distances and leaves bitwise equal to the
    reference's device path, and each row to both packages' host
    ``extended_search``, for nbr 1, 2, 4, 8 and the whole-tree budget.  The
    host's DTW DP is pure Python (~4 s a query over the whole tree), so DTW
    holds one query against the hosts, and at the whole-tree budget only on
    the plain layout."""
    ri, pi = request.getfixturevalue(layout)
    n_q = 6 if metric == "ed" else 2
    qs = random_walks(n_q, 64, seed=91)
    L = pi.flat.n_leaves
    for nbr in (1, 2, 4, 8, L + 5):
        got = _ext(pi, qs, nbr, metric=metric, band=BAND)
        _assert_equal(got, r_ext(ri, qs, K, nbr=nbr, metric=metric,
                                 band=BAND))
        assert got[2].shape == (n_q, min(nbr, L))
        assert not np.isin(got[0], VICTIMS).any()
        rows = range(n_q) if metric == "ed" else range(1)
        if metric == "dtw" and nbr > L and layout == "fuzzy":
            rows = range(0)
        for i in rows:
            for host in (ps, rs):
                h_ids, h_d, _ = host.extended_search(
                    pi if host is ps else ri, qs[i], K, nbr, metric=metric,
                    band=BAND)
                m = len(h_ids)
                np.testing.assert_array_equal(got[0][i, :m], h_ids)
                np.testing.assert_array_equal(got[1][i, :m], h_d)
                assert (got[0][i, m:] == -1).all()


def _stop_parent_width(index, q, nbr, metric):
    """Leaf-span width of the node whose children form the query's sibling
    set (the host ``extended_search`` descent)."""
    paa, sax = ps._encode_query(index, q)
    b, n = index.params.sax.b, index.n
    qseg = ps.query_prep_np(ps.resolve(metric, n, BAND), q, paa)[:2]
    parent, node = None, index.root
    while not node.is_leaf and node.n_leaves > nbr:
        sid = node.route_sid(sax, b)
        child = node.routing.get(sid) or node.children.get(sid)
        if child is None:
            child = min(node.children.values(),
                        key=lambda c: ps._node_lb(c, qseg, n, b))
        parent, node = node, child
    ids = [lf.leaf_id for lf in ps._leaves_under(parent)]
    return max(ids) - min(ids) + 1


@pytest.mark.parametrize("metric", ["ed", "dtw"])
def test_schedule_branches_equal_reference(plain, metric, monkeypatch):
    """Both branches of the reference's ``_sibling_schedule`` against the
    port's, which always ranks all ``L`` leaves.  At these sizes the root
    has leaf children, so ``stop_span_cap`` is ``L`` for every nbr and the
    reference ranks all ``L`` leaves too.  Its window branch
    (``span_cap < L``) is reached by capping the reference at the widest
    sibling set a batch needs (any cap at least that wide is exact), for a
    batch of the queries whose sibling set is not the root's: the port's
    leaves, ids and distances are bitwise equal to the reference's in both
    branches, and capping the port's ``FlatRouting`` changes nothing."""
    ri, pi = plain
    L = pi.flat.n_leaves
    pool = random_walks(48, 64, seed=17)
    for nbr in (1, 2, 4):          # at nbr 8 every query stops at the root
        assert pi.routing_flat.stop_span_cap(nbr) == L
        width = np.array([_stop_parent_width(pi, q, nbr, metric)
                          for q in pool])
        qs = pool[width < L][:12]
        assert len(qs) >= 4
        full = _ext(pi, qs, nbr, metric=metric, band=BAND)
        _assert_equal(full, r_ext(ri, qs, K, nbr=nbr, metric=metric,
                                  band=BAND))
        cap = int(width[width < L].max())
        for cls in (FlatRouting, RFlatRouting):
            monkeypatch.setattr(cls, "stop_span_cap",
                                lambda self, nbr, cap=cap: cap)
        got = _ext(pi, qs, nbr, metric=metric, band=BAND)
        _assert_equal(got, r_ext(ri, qs, K, nbr=nbr, metric=metric,
                                 band=BAND))
        _assert_equal(got, full)
        monkeypatch.undo()


def test_nbr1_equals_approximate(plain):
    _, pi = plain
    qs = random_walks(12, 64, seed=31)
    ids, d, leaves = _ext(pi, qs, 1)
    for i, q in enumerate(qs):
        a_ids, a_d, _ = ps.approximate_search(pi, q, K)
        np.testing.assert_array_equal(ids[i][ids[i] >= 0], a_ids)
        np.testing.assert_array_equal(d[i][:len(a_d)], a_d)
        paa, sax = ps._encode_query(pi, q)
        assert leaves[i, 0] == ps.route_to_leaf(pi, paa, sax).leaf_id


@pytest.mark.parametrize("metric", ["ed", "dtw"])
def test_kth_distance_monotone_in_nbr(fuzzy, metric):
    """The nbr visit set holds the smaller budgets' sets, so the k-th
    distance never grows with nbr (fuzzy layout with tombstones)."""
    _, pi = fuzzy
    qs = random_walks(6, 64, seed=60_001)
    prev = np.full(len(qs), np.inf)
    for nbr in (1, 2, 4, 8, 32):
        _, d, _ = _ext(pi, qs, nbr, metric=metric, band=BAND)
        kth = d[:, K - 1]
        assert (kth <= prev).all(), (nbr, kth, prev)
        prev = kth


@pytest.mark.parametrize("metric", ["ed", "dtw"])
@pytest.mark.parametrize("rerank", [True, False])
def test_one_and_four_shards_bitwise(fuzzy, metric, rerank):
    _, pi = fuzzy
    qs = random_walks(6, 64, seed=23)
    one = _ext(pi, qs, 4, metric=metric, band=BAND, rerank=rerank)
    _assert_equal(_ext(pi, qs, 4, metric=metric, band=BAND, rerank=rerank,
                       n_shards=4), one)


@pytest.mark.parametrize("metric", ["ed", "dtw"])
def test_degraded_mode_matches_reference(plain, metric):
    ri, pi = plain
    qs = random_walks(6, 64, seed=7)
    health = (True, False, True, True)
    got = _ext(pi, qs, 4, n_shards=4, shard_health=health, metric=metric,
               band=BAND)
    want = r_ext(ri, qs, K, nbr=4, dev=RDev.from_index(ri, n_shards=4),
                 shard_health=health, metric=metric, band=BAND)
    _assert_equal(got, want)
    assert 0.0 < got[3] < 1.0


@pytest.mark.parametrize("metric", ["ed", "dtw"])
def test_rerank_false_same_ids_within_ties(plain, metric):
    """The on-device variant: the reference's answer by the rtol 1e-5 tie
    rule, the host's id set, and ascending device distances."""
    ri, pi = plain
    qs = random_walks(6, 64, seed=17)
    ids, d, leaves = _ext(pi, qs, 4, rerank=False, metric=metric, band=BAND)
    r_ids, r_d, r_leaves = r_ext(ri, qs, K, nbr=4, rerank=False,
                                 metric=metric, band=BAND)
    np.testing.assert_array_equal(leaves, r_leaves)
    assert_ties_only(ids, d, r_ids, r_d)
    for i, q in enumerate(qs):
        h_ids, _, _ = ps.extended_search(pi, q, K, 4, metric=metric,
                                         band=BAND)
        assert set(ids[i][ids[i] >= 0].tolist()) == set(h_ids.tolist())
        assert (np.diff(d[i][np.isfinite(d[i])]) >= 0).all()


def test_empty_index():
    ri, pi = build_pair(np.zeros((0, 64), np.float32))
    qs = random_walks(3, 64, seed=5)
    for rerank in (True, False):
        got = _ext(pi, qs, 4, rerank=rerank)
        _assert_equal(got, r_ext(ri, qs, K, nbr=4, rerank=rerank))
        assert (got[0] == -1).all() and np.isinf(got[1]).all()
    ids, d, _ = exact_search_device_batch(pi, qs, 5, device=CPU)
    assert (ids == -1).all() and np.isinf(d).all()


@pytest.mark.parametrize("metric", ["ed", "dtw"])
def test_degenerate_one_leaf_tree(metric):
    ri, pi = build_pair(random_walks(50, 64, seed=3))
    assert pi.root.is_leaf and pi.routing_flat.stop_span_cap(1) == 1
    qs = random_walks(3, 64, seed=4)
    for nbr in (1, 4):
        got = _ext(pi, qs, nbr, metric=metric, band=BAND)
        _assert_equal(got, r_ext(ri, qs, K, nbr=nbr, metric=metric,
                                 band=BAND))
        assert (got[2] == 0).all()
        h_ids, h_d, _ = ps.extended_search(pi, qs[0], K, nbr, metric=metric,
                                           band=BAND)
        np.testing.assert_array_equal(got[0][0], h_ids)
        np.testing.assert_array_equal(got[1][0], h_d)


@pytest.mark.parametrize("bad,exc", [
    (np.full((2, 64), np.nan), ValueError),
    (np.zeros((2, 63)), ValueError),
    (np.zeros((2, 2, 64)), ValueError),
    (np.array([["a"] * 64]), TypeError),
])
def test_validation_messages_equal_reference(plain, bad, exc):
    ri, pi = plain
    for port, ref in ((extended_search_device_batch, r_ext),):
        with pytest.raises(exc) as got:
            port(pi, bad, K, device=CPU)
        with pytest.raises(exc) as want:
            ref(ri, bad, K)
        assert str(got.value) == str(want.value)
    assert str(lane_finite_error()) == str(r_lane_error())
    assert type(lane_finite_error()) is type(r_lane_error())


@pytest.mark.parametrize("layout", ["plain", "fuzzy", "one_leaf"])
def test_stop_span_cap_equals_reference(layout, request):
    if layout == "one_leaf":
        ri, pi = build_pair(random_walks(50, 64, seed=3))
    else:
        ri, pi = request.getfixturevalue(layout)
    rr, pr = ri.routing_flat, pi.routing_flat
    L = pi.flat.n_leaves
    caps = [pr.stop_span_cap(nbr) for nbr in range(1, L + 2)]
    assert caps == [rr.stop_span_cap(nbr) for nbr in range(1, L + 2)]
    assert caps == sorted(caps) and 1 <= caps[0] and caps[-1] <= max(L, 1)
    if layout == "one_leaf":
        assert caps == [1] * (L + 1)


@pytest.mark.parametrize("metric", ["ed", "dtw"])
def test_sort_keys_hold_no_negative_zero(plain, metric):
    """XLA sorts floats in a total order (-0.0 before +0.0), torch's stable
    sort treats them as equal; the schedule's keys are sums of squares (the
    leaf bounds, the sibling bounds and the ED distances), which are never
    -0.0, so the two orders agree.  Queries far outside the data and a
    query equal to a collection row give many exact zeros."""
    import torch
    from repro_torch.core.search_device import _prep_batch
    from repro_torch.kernels import ops
    _, pi = plain
    dev = pi.device_index(device=CPU)
    qs = np.concatenate([random_walks(8, 64, seed=3), pi.db[:2],
                         4.0 * random_walks(2, 64, seed=101) + 3.0])
    met = ps.resolve(metric, 64, BAND)
    prep, _ = _prep_batch(met, torch.from_numpy(qs.astype(np.float32)),
                          pi.params.sax.w, pi.params.sax.b)
    zeros = 0
    for lo, hi in ((dev.leaf_lo_g, dev.leaf_hi_g), (dev.grp_lo, dev.grp_hi),
                   (dev.rt_lo, dev.rt_hi)):
        lb = ops.lb_paa_interval(prep[0], prep[1], lo, hi, dev.n).numpy()
        fin = np.isfinite(lb)
        assert not np.signbit(lb[fin]).any()
        zeros += int((lb[fin] == 0).sum())
    d2 = ((torch.from_numpy(pi.db[:50])[None] - prep[3][:, None]) ** 2
          ).sum(-1).numpy()
    assert not np.signbit(d2).any() and (d2 == 0).any() == (metric == "ed")
    assert zeros > 0
