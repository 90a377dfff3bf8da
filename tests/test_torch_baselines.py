"""The port's baseline indexes (``repro_torch.core.baselines``) against the
reference's (``repro.core.baselines``) on the same data: twins of every
``tests/test_baselines.py`` test, iSAX2+ and TARDIS layouts bitwise the
reference's, DSTree answers bitwise, the brute force bitwise, and the
port's device searches over each baseline index bitwise the reference's
host search over the reference-built index (on the CPU)."""
import numpy as np
import pytest

from _torch_port import params_pair, torch_threads  # noqa: F401
from repro.core.baselines.brute import brute_force_knn as r_brute
from repro.core.baselines.dstree import DSTreeIndex as RDSTree
from repro.core.baselines.isax2plus import build_isax2plus as r_isax2plus
from repro.core.baselines.tardis import build_tardis as r_tardis
from repro.core.search import exact_search as r_exact_host
from repro.core.search import extended_search as r_extended_host
from repro.data.series import random_walks
from repro_torch.core.baselines.brute import brute_force_knn
from repro_torch.core.baselines.dstree import DSTreeIndex
from repro_torch.core.baselines.isax2plus import build_isax2plus
from repro_torch.core.baselines.tardis import build_tardis
from repro_torch.core.index import DumpyIndex
from repro_torch.core.lb import ed_np
from repro_torch.core.search import exact_search
from repro_torch.core.search_device import (approximate_search_device_batch,
                                            exact_search_device_batch,
                                            extended_search_device_batch)

CPU = "cpu"
R_PARAMS, PARAMS = params_pair(w=8, b=8, th=128)
BUILDERS = {"isax2plus": (build_isax2plus, r_isax2plus),
            "tardis": (build_tardis, r_tardis)}


@pytest.fixture(scope="module")
def db():
    return random_walks(5000, 64, seed=1)


@pytest.fixture(scope="module")
def built(db):
    """Each baseline built by both packages over ``db``."""
    return {name: (port(db, PARAMS), ref(db, R_PARAMS))
            for name, (port, ref) in BUILDERS.items()}


@pytest.fixture(scope="module")
def dstree(db):
    return DSTreeIndex(db, th=128), RDSTree(db, th=128)


# ---------------------------------------------------------------------------
# twins of tests/test_baselines.py
# ---------------------------------------------------------------------------

def test_isax2plus_binary_structure(built, db):
    idx = built["isax2plus"][0]

    def check(node, depth):
        if node.is_leaf:
            return
        if depth > 0:
            assert len(node.csl) == 1
        seen = set()
        for c in node.children.values():
            if id(c) not in seen:
                seen.add(id(c))
                check(c, depth + 1)
    check(idx.root, 0)
    counts = np.bincount(idx.flat.order, minlength=len(db))
    assert np.all(counts == 1)


def test_tardis_full_ary_structure(built):
    idx = built["tardis"][0]

    def check(node):
        if node.is_leaf:
            return
        w = len(node.sym)
        assert len(node.csl) == sum(
            1 for j in range(w)
            if node.card[j] - (1 if j in node.csl else 0) < PARAMS.sax.b)
        seen = set()
        for c in node.children.values():
            if id(c) not in seen:
                seen.add(id(c))
                check(c)
    check(idx.root)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_baseline_exact_search_correct(built, db, name):
    idx = built[name][0]
    q = random_walks(1, 64, seed=77)[0]
    gt, gt_d = brute_force_knn(db, q, 10)
    ids, d, _ = exact_search(idx, q, 10)
    np.testing.assert_allclose(np.sort(d), np.sort(gt_d), atol=1e-3)


def test_dstree_exact_search_correct(dstree, db):
    ds = dstree[0]
    q = random_walks(1, 64, seed=78)[0]
    gt, gt_d = brute_force_knn(db, q, 10)
    ids, d, _ = ds.exact_search(q, 10)
    np.testing.assert_allclose(np.sort(d), np.sort(gt_d), atol=1e-3)


def test_dstree_lb_is_lower_bound(db):
    ds = DSTreeIndex(db, th=256)
    q = random_walks(1, 64, seed=79)[0]
    for leaf in ds._leaves(ds.root)[:20]:
        lb = ds._lb(leaf, q)
        true = ed_np(q, db[leaf.series_ids]).min()
        assert lb <= true + 1e-3


def test_structure_statistics_ranking():
    """Table-1 qualitative ranking: Dumpy's fill factor above iSAX2+'s."""
    _, params = params_pair(w=16, b=8, th=128)
    dmp = DumpyIndex.build(random_walks(8000, 64, seed=2), params)
    isx = build_isax2plus(random_walks(8000, 64, seed=2), params)
    assert dmp.stats.fill_factor > isx.stats.fill_factor


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_baseline_layout_bitwise_reference(built, name):
    idx, ref = built[name]
    for f in ("order", "leaf_offsets", "leaf_lo", "leaf_hi"):
        a, b = getattr(idx.flat, f), getattr(ref.flat, f)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert vars(idx.stats) == vars(ref.stats)
    np.testing.assert_array_equal(idx.sax, ref.sax)


def test_dstree_bitwise_reference(dstree):
    ds, rds = dstree
    assert (ds.n_leaves, ds.height, ds.fill_factor, ds.stats_raw_touches) \
        == (rds.n_leaves, rds.height, rds.fill_factor, rds.stats_raw_touches)
    for i, q in enumerate(random_walks(4, 64, seed=80)):
        pairs = [(ds.exact_search(q, 10), rds.exact_search(q, 10)),
                 (ds.approximate_search(q, 10),
                  rds.approximate_search(q, 10)),
                 (ds.extended_search(q, 10, 2 + i),
                  rds.extended_search(q, 10, 2 + i))]
        for (ids, d, st), (r_ids, r_d, r_st) in pairs:
            np.testing.assert_array_equal(ids, r_ids)
            np.testing.assert_array_equal(d, r_d)
            assert vars(st) == vars(r_st)


def test_brute_force_bitwise_reference(db):
    q = random_walks(1, 64, seed=81)[0]
    for kw in ({}, {"metric": "dtw", "band": 6}):
        x = db[:400] if kw else db
        ids, d = brute_force_knn(x, q, 10, **kw)
        r_ids, r_d = r_brute(x, q, 10, **kw)
        np.testing.assert_array_equal(ids, r_ids)
        np.testing.assert_array_equal(d, r_d)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_device_search_on_baseline_bitwise_reference_host(built, name):
    """The port's device paths run on a baseline index unchanged: exact
    (one and four shards) and extended with re-rank bitwise the reference
    host search over the reference-built index; approximate at nbr=1 in
    the routed leaf."""
    idx, ref = built[name]
    qs = random_walks(6, 64, seed=82)
    for S in (1, 4):
        ids, d, _ = exact_search_device_batch(idx, qs, 10, chunk=256,
                                              n_shards=S, device=CPU)
        for i, q in enumerate(qs):
            h_ids, h_d, _ = r_exact_host(ref, q, 10)
            np.testing.assert_array_equal(ids[i], h_ids)
            np.testing.assert_array_equal(d[i], h_d)
    for nbr in (1, 4):
        ids, d, _ = extended_search_device_batch(idx, qs, 10, nbr=nbr,
                                                 device=CPU)
        for i, q in enumerate(qs):
            h_ids, h_d, _ = r_extended_host(ref, q, 10, nbr)
            np.testing.assert_array_equal(ids[i][ids[i] >= 0], h_ids)
            np.testing.assert_array_equal(d[i][:len(h_d)], h_d)
    ids, d, leaves = approximate_search_device_batch(idx, qs, 10, nbr=1,
                                                     device=CPU)
    offs = idx.flat.leaf_offsets
    for i in range(len(qs)):
        rows = idx.flat.order[offs[leaves[i, 0]]:offs[leaves[i, 0] + 1]]
        assert np.isin(ids[i][ids[i] >= 0], rows).all()
