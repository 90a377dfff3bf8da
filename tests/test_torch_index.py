"""The port's host build against the reference: the same data and
parameters give the same tree, leaf layout and routing tables, before and
after ``insert_many`` and ``delete``."""
import dataclasses

import numpy as np
import pytest

from _torch_port import build_pair, torch_threads  # noqa: F401
from repro.data import series as r_series
from repro_torch.core.build import DumpyParams
from repro_torch.core.index import DumpyIndex
from repro_torch.data import series

CASES = {"plain": dict(n=4000, seed=0, fuzzy_f=0.0),
         "fuzzy": dict(n=2500, seed=2, fuzzy_f=0.15)}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    c = CASES[request.param]
    db = r_series.random_walks(c["n"], 64, seed=c["seed"])
    return build_pair(db, fuzzy_f=c["fuzzy_f"])


def _assert_same_tree(a, b, path="root"):
    assert a.is_leaf == b.is_leaf, path
    np.testing.assert_array_equal(a.sym, b.sym, err_msg=path)
    np.testing.assert_array_equal(a.card, b.card, err_msg=path)
    assert (a.size, a.depth, a.n_leaves, a.is_pack, a.pack_mask,
            a.pack_value, a.leaf_id) == \
        (b.size, b.depth, b.n_leaves, b.is_pack, b.pack_mask, b.pack_value,
         b.leaf_id), path
    if a.is_leaf:
        np.testing.assert_array_equal(a.series_ids, b.series_ids,
                                      err_msg=path)
        return
    assert a.csl == b.csl, path
    assert list(a.children) == list(b.children), path     # insertion order
    assert list(a.routing) == list(b.routing), path
    seen = set()
    for sid in a.children:
        if id(a.children[sid]) in seen:
            continue
        seen.add(id(a.children[sid]))
        _assert_same_tree(a.children[sid], b.children[sid], f"{path}/{sid}")


def _assert_same_layout(ri, pi):
    _assert_same_tree(ri.root, pi.root)
    assert dataclasses.asdict(ri.stats) == dataclasses.asdict(pi.stats)
    for f in ("leaf_sym", "leaf_card", "leaf_lo", "leaf_hi", "leaf_offsets",
              "order"):
        a, b = getattr(ri.flat, f), getattr(pi.flat, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    rr, pr = ri.routing_flat, pi.routing_flat
    for f in dataclasses.fields(rr):
        a, b = getattr(rr, f.name), getattr(pr, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert rr.gmax == pr.gmax
    np.testing.assert_array_equal(ri.db_ordered, pi.db_ordered)
    np.testing.assert_array_equal(ri.paa, pi.paa)
    np.testing.assert_array_equal(ri.sax, pi.sax)
    np.testing.assert_array_equal(ri.alive, pi.alive)


def test_build_gives_identical_tree_and_layout(pair):
    ri, pi = pair
    _assert_same_layout(ri, pi)


def test_insert_many_and_delete_keep_parity():
    db = r_series.random_walks(1500, 64, seed=4)
    ri, pi = build_pair(db, fuzzy_f=0.15)
    extra = r_series.random_walks(400, 64, seed=5)
    np.testing.assert_array_equal(ri.insert_many(extra, log_wal=False),
                                  pi.insert_many(extra))
    for v in (3, 77, 1600):
        ri.delete(v)
        pi.delete(v)
    assert ri.insert(extra[0]) == pi.insert(extra[0])
    _assert_same_layout(ri, pi)
    assert pi._n_layout_builds >= 1


def test_build_backend_choices():
    db = series.random_walks(300, 64, seed=1)
    host = DumpyIndex.build(db, DumpyParams())
    dev = DumpyIndex.build(db, DumpyParams(), backend="device", device="cpu")
    np.testing.assert_array_equal(dev.flat.order, host.flat.order)
    np.testing.assert_array_equal(dev.flat.leaf_offsets,
                                  host.flat.leaf_offsets)
    with pytest.raises(ValueError, match="unknown build backend"):
        DumpyIndex.build(db, DumpyParams(), backend="gpu")


@pytest.mark.parametrize("n,length,seed", [(50, 64, 0), (7, 96, 3)])
def test_series_generators_bitwise(n, length, seed):
    for fn in ("random_walks", "query_workload"):
        a = getattr(series, fn)(n, length, seed)
        b = getattr(r_series, fn)(n, length, seed)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(seed).standard_normal((n, length))
    np.testing.assert_array_equal(series.z_normalize(x),
                                  r_series.z_normalize(x))
