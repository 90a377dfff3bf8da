"""The port's batched approximate search
(``approximate_search_device_batch``) against the reference's and against
the host ``route_to_leaf`` (twins of ``tests/test_batch_search.py``'s
approximate cases), on the CPU (``device="cpu"``).

Tolerances.  Leaf schedules are compared bitwise.  Ids and distances come
from each package's own float32 sums (no host re-rank on this path), so
distances must agree within rtol 1e-5, and ids must be equal except where
the two distances at a position are tied with a neighbour within that
same rtol (then the order of the tied ids may differ)."""
import numpy as np
import pytest

from _torch_port import (assert_ties_only, build_pair,
                         torch_threads)  # noqa: F401
from repro.core.baselines.brute import brute_force_knn
from repro.core.device_index import DeviceIndex as RDev
from repro.core.search_device import approximate_search_device_batch as r_apx
from repro.data.series import random_walks
from repro_torch.core import search as ps
from repro_torch.core.search_device import approximate_search_device_batch

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


def _takes_fallback(index, sax_q) -> bool:
    """Whether the host descent of one query meets an empty region."""
    b = index.params.sax.b
    node = index.root
    while not node.is_leaf:
        sid = node.route_sid(sax_q, b)
        child = node.routing.get(sid) or node.children.get(sid)
        if child is None:
            return True
        node = child
    return False


@pytest.mark.parametrize("scale", ["in_distribution", "adversarial"])
@pytest.mark.parametrize("metric", ["ed", "dtw"])
def test_leaf_selection_matches_host(plain, scale, metric):
    """``nbr=1`` routes every query to the host ``route_to_leaf`` leaf.
    Adversarial queries (``4·walk + 3``) hit empty routing regions, so the
    min-bound fallback (the first of equal bounds) is exercised."""
    _, pi = plain
    qs = random_walks(32, 64, seed=44)
    if scale == "adversarial":
        qs = 4.0 * random_walks(8, 64, seed=101) + 3.0
    _, _, leaves = approximate_search_device_batch(pi, qs, K, metric=metric,
                                                   band=BAND, device=CPU)
    met = ps.resolve(metric, 64, BAND)
    falls = 0
    for i, q in enumerate(qs):
        paa, sax = ps._encode_query(pi, q)
        seg = ps.query_prep_np(met, q, paa)[:2]
        assert leaves[i, 0] == ps.route_to_leaf(pi, paa, sax, qseg=seg).leaf_id
        falls += _takes_fallback(pi, sax)
    assert (falls > 0) == (scale == "adversarial")


@pytest.mark.parametrize("layout", ["plain", "fuzzy"])
@pytest.mark.parametrize("metric", ["ed", "dtw"])
@pytest.mark.parametrize("nbr", [1, 4, 16])
def test_matches_reference(layout, metric, nbr, request):
    """``leaves`` bitwise equal to the reference's; ids and distances by
    the rtol 1e-5 tie rule."""
    ri, pi = request.getfixturevalue(layout)
    qs = random_walks(12, 64, seed=91)
    ids, d, leaves = approximate_search_device_batch(
        pi, qs, K, nbr=nbr, metric=metric, band=BAND, device=CPU)
    r_ids, r_d, r_leaves = r_apx(ri, qs, K, nbr=nbr, metric=metric, band=BAND)
    np.testing.assert_array_equal(leaves, r_leaves)
    assert ids.dtype == np.int64 and d.dtype == np.float32
    assert_ties_only(ids, d, r_ids, r_d)
    assert not np.isin(ids, VICTIMS).any()


def test_nbr1_matches_host_loop(fuzzy):
    """Per query, the device ids equal the host ``approximate_search``'s
    (rtol 1e-5 tie rule against the host's float32 distances)."""
    _, pi = fuzzy
    qs = random_walks(12, 64, seed=91)
    ids, d, _ = approximate_search_device_batch(pi, qs, K, device=CPU)
    for i, q in enumerate(qs):
        h_ids, h_d, _ = ps.approximate_search(pi, q, K)
        m = len(h_ids)
        assert (ids[i, m:] == -1).all()
        assert_ties_only(ids[i:i + 1, :m], d[i:i + 1, :m], h_ids[None],
                         h_d[None])


@pytest.mark.parametrize("nbr", [1, 4])
def test_fuzzy_rows_deduped(fuzzy, nbr):
    _, pi = fuzzy
    qs = random_walks(16, 64, seed=67)
    ids, _, _ = approximate_search_device_batch(pi, qs, K, nbr=nbr,
                                                device=CPU)
    for row in ids:
        got = row[row >= 0]
        assert len(np.unique(got)) == len(got)


def test_nbr_widens_coverage(plain):
    ri, pi = plain
    qs = random_walks(6, 64, seed=55)
    ids1, _, leaves1 = approximate_search_device_batch(pi, qs, K, nbr=1,
                                                       device=CPU)
    ids4, _, leaves4 = approximate_search_device_batch(pi, qs, K, nbr=4,
                                                       device=CPU)
    assert leaves4.shape == (6, 4)
    np.testing.assert_array_equal(leaves1[:, 0], leaves4[:, 0])
    alive = ri.alive
    gt = [set(brute_force_knn(ri.db[alive], q, K)[0].tolist()) for q in qs]
    live = np.nonzero(alive)[0]
    gt = [set(live[list(g)].tolist()) for g in gt]
    r1 = np.mean([len(gt[i] & set(ids1[i].tolist())) for i in range(6)])
    r4 = np.mean([len(gt[i] & set(ids4[i].tolist())) for i in range(6)])
    assert r4 >= r1


def test_shards_and_degraded_mode_match_reference(plain):
    """The flattened ``[S·Tp, n]`` view: four shards give the one-shard
    answer, and a dead shard's rows read as tombstoned, as in the
    reference."""
    ri, pi = plain
    qs = random_walks(8, 64, seed=23)
    one = approximate_search_device_batch(pi, qs, K, nbr=4, device=CPU)
    four = approximate_search_device_batch(pi, qs, K, nbr=4, n_shards=4,
                                           device=CPU)
    for a, b in zip(one, four):
        np.testing.assert_array_equal(a, b)
    health = (True, False, True, True)
    dev = pi.device_index(n_shards=4, device=CPU).with_shard_health(health)
    r_dev = RDev.from_index(ri, n_shards=4).with_shard_health(health)
    ids, d, leaves = approximate_search_device_batch(pi, qs, K, nbr=4,
                                                     dev=dev, device=CPU)
    r_ids, r_d, r_leaves = r_apx(ri, qs, K, nbr=4, dev=r_dev)
    np.testing.assert_array_equal(leaves, r_leaves)
    assert_ties_only(ids, d, r_ids, r_d)
    # the plain layout holds each id once: the dead shard's ids are gone
    dead = pi.flat.order[dev.row_bounds[1]:dev.row_bounds[2]]
    assert not np.isin(ids, dead).any()


def test_degenerate_tree_and_nbr_past_leaves():
    """The root is the only leaf: every query routes to leaf 0; ``nbr``
    past the leaf count is cut to it."""
    ri, pi = build_pair(random_walks(50, 64, seed=3))
    assert pi.root.is_leaf
    qs = random_walks(4, 64, seed=4)
    for nbr in (1, 5):
        ids, d, leaves = approximate_search_device_batch(pi, qs, K, nbr=nbr,
                                                         device=CPU)
        r_ids, r_d, r_leaves = r_apx(ri, qs, K, nbr=nbr)
        np.testing.assert_array_equal(leaves, r_leaves)
        assert leaves.shape == (4, 1) and (leaves == 0).all()
        assert_ties_only(ids, d, r_ids, r_d)
    _, pi = build_pair(random_walks(4000, 64, seed=0))
    L = pi.flat.n_leaves
    _, _, leaves = approximate_search_device_batch(pi, qs, K, nbr=L + 7,
                                                   device=CPU)
    assert leaves.shape == (4, L)
    assert all(sorted(row) == list(range(L)) for row in leaves)


def test_near_tied_leaf_bounds_rank_as_the_kernel_does():
    """ROADMAP C8: query 5 of this case has leaves 25 and 129 a few ulps
    apart in torch's ``.sum(-1)`` order and equal in the kernel's in-order
    sum.  The CPU twin of ``lb_paa_interval`` is that in-order sum, so:

    * every approximate schedule is bitwise the stable ranking of the
      in-order bounds (routed leaf first), as the card's kernel gives it;
    * it equals the reference's schedule except where two leaves' in-order
      bounds lie within 4 ulps (here: nowhere, at nbr 184 and 185, where
      the pair straddles the budget);
    * wherever the visited sets are equal, so are the answers (approximate
      by the rtol 1e-5 tie rule, extended bitwise after the re-rank)."""
    import torch
    from repro.core.search_device import extended_search_device_batch as r_ext
    from repro_torch.core import search_device as sd
    from repro_torch.core.metric import resolve
    from repro_torch.kernels import ops, ref
    ri, pi = build_pair(random_walks(1800, 96, seed=1800), w=12, th=40,
                        fuzzy_f=0.2)
    qs = random_walks(9, 96, seed=1801)
    dev = pi.device_index(device=CPU)
    prep, _ = sd._prep_batch(resolve("dtw", 96, 3), torch.from_numpy(qs),
                             pi.params.sax.w, pi.params.sax.b)
    args = (prep[0], prep[1], dev.leaf_lo_g, dev.leaf_hi_g, dev.n)
    lb = ref.lb_paa_interval_in_order(*args)
    assert torch.equal(ops.lb_paa_interval(*args), lb)
    # the pair of the fault: apart in torch's order, equal in order
    old = ref.lb_paa_interval_ref(*args)
    assert old[5, 25] != old[5, 129] and lb[5, 25] == lb[5, 129]
    for nbr in (184, 185):
        ids, d, leaves = approximate_search_device_batch(
            pi, qs, 7, nbr=nbr, metric="dtw", band=3, device=CPU)
        routed = torch.from_numpy(leaves[:, :1]).long()
        want = torch.sort(lb.scatter(1, routed, -np.inf), stable=True)[1]
        np.testing.assert_array_equal(leaves, want[:, :nbr].numpy())
        r_ids, r_d, r_leaves = r_apx(ri, qs, 7, nbr=nbr, metric="dtw", band=3)
        for i, j in np.argwhere(leaves != r_leaves):
            a, b = lb[i, leaves[i, j]], lb[i, r_leaves[i, j]]
            assert abs(float(a - b)) <= 4 * float(torch.finfo().eps) * \
                float(max(a, b)), (nbr, i, j)
        same = [set(leaves[i]) == set(r_leaves[i]) for i in range(len(qs))]
        assert_ties_only(ids[same], d[same], r_ids[same], r_d[same])
    e = sd.extended_search_device_batch(pi, qs, 7, nbr=1000, metric="dtw",
                                        band=3, device=CPU)
    r = r_ext(ri, qs, 7, nbr=1000, metric="dtw", band=3)
    np.testing.assert_array_equal(e[2], r[2])
    np.testing.assert_array_equal(e[0], r[0])
    np.testing.assert_array_equal(e[1], r[1])
