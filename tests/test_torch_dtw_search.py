"""The port's exact DTW search against the reference's
``exact_search_device_batch(metric="dtw")`` and the host
``exact_search(metric="dtw")``: ids and distances bitwise, ``spans_visited``
and the five cascade counters equal, for the three candidate orders, on
plain and fuzzy layouts with tombstones, for one and four shards (on the
CPU, ``device="cpu"``)."""
import numpy as np
import pytest

from _torch_port import build_pair, torch_threads  # noqa: F401
from repro.core.device_index import DeviceIndex as RDev
from repro.core.search import exact_search
from repro.core.search_device import exact_search_device_batch as r_batch
from repro.data.series import random_walks
from repro_torch.core import search_device
from repro_torch.core.metric import ORDERS
from repro_torch.core.search_device import (STAT_KEYS,
                                            exact_search_device_batch)

CPU = "cpu"
K = 5
BAND = 6
VICTIMS = (3, 17, 400)
COUNTERS = STAT_KEYS + ("dp_survivors",)


def _tombstone(ri, pi):
    for v in VICTIMS:
        ri.delete(v)
        pi.delete(v)
    return ri, pi


@pytest.fixture(scope="module")
def plain():
    return _tombstone(*build_pair(random_walks(900, 64, seed=1), th=64))


@pytest.fixture(scope="module")
def fuzzy():
    ri, pi = build_pair(random_walks(900, 64, seed=2), th=64, fuzzy_f=0.15)
    assert pi.stats.n_duplicates > 0
    return _tombstone(ri, pi)


def _both(ri, pi, qs, S=1, chunk=2048, **kw):
    """``(port, reference)`` results of one DTW batch, stats included."""
    got = exact_search_device_batch(pi, qs, K, chunk=chunk, n_shards=S,
                                    metric="dtw", band=BAND,
                                    return_stats=True, device=CPU, **kw)
    want = r_batch(ri, qs, K, dev=RDev.from_index(ri, chunk=chunk,
                                                  n_shards=S),
                   metric="dtw", band=BAND, return_stats=True, **kw)
    return got, want


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(a, b)
    assert {c: got[-1][c] for c in COUNTERS} == want[-1]


_HOST = {}


def _assert_host(ri, qs, ids, d):
    """Per query against the host search (the scalar DTW heap search is
    slow, so its answers are kept per index and query)."""
    for i, q in enumerate(qs):
        key = (id(ri), q.tobytes())
        if key not in _HOST:
            _HOST[key] = exact_search(ri, q, K, metric="dtw", band=BAND)[:2]
        h_ids, h_d = _HOST[key]
        np.testing.assert_array_equal(ids[i][ids[i] >= 0], h_ids)
        np.testing.assert_array_equal(d[i][:len(h_d)], h_d)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("layout", ["plain", "fuzzy"])
@pytest.mark.parametrize("S", [1, 4])
def test_dtw_batch_bitwise_equals_reference_and_host(order, layout, S,
                                                     request):
    ri, pi = request.getfixturevalue(layout)
    qs = random_walks(6, 64, seed=8)
    got, want = _both(ri, pi, qs, S, order=order)
    _assert_same(got, want)
    ids, d = got[:2]
    assert not np.isin(ids, VICTIMS).any()
    for row in ids:                                  # fuzzy dedup held
        live = row[row >= 0]
        assert len(np.unique(live)) == len(live) == K
    _assert_host(ri, qs, ids, d)


@pytest.mark.parametrize("chunk", [256, 512])
def test_dtw_shared_order_other_chunks_match_reference(fuzzy, chunk):
    """chunk 512: several spans, each cut into two ``DTW_SUB`` sub-slabs;
    chunk 256: one sub-slab per span (no sub-blocking)."""
    ri, pi = fuzzy
    qs = random_walks(6, 64, seed=8)
    got, want = _both(ri, pi, qs, chunk=chunk, order="shared")
    _assert_same(got, want)
    _assert_host(ri, qs, *got[:2])


@pytest.mark.parametrize("Q", [1, 3, 16, 17, 32])
def test_cluster_grouping_odd_and_grouped_batches(plain, Q):
    """Batch sizes that split into 1, 2 or 4 query groups: equal to the
    reference, and bitwise equal to the ungrouped ``"perq"`` walk."""
    ri, pi = plain
    qs = random_walks(Q, 64, seed=20 + Q)
    got, want = _both(ri, pi, qs, order="cluster")
    _assert_same(got, want)
    perq = exact_search_device_batch(pi, qs, K, metric="dtw", band=BAND,
                                     order="perq", device=CPU)
    for a, b in zip(got[:2], perq[:2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("order", ["shared", "cluster"])
def test_dtw_degraded_mode_matches_reference(plain, order):
    ri, pi = plain
    qs = random_walks(6, 64, seed=7)
    health = (True, False, True, True)
    got, want = _both(ri, pi, qs, 4, order=order, shard_health=health)
    _assert_same(got, want)
    assert 0.0 < got[3] < 1.0


@pytest.mark.parametrize("order", ["shared", "perq"])
def test_stop_test_interval_is_exact_for_dtw(plain, order, monkeypatch):
    """Testing the stop condition every G steps instead of every step
    changes neither the results nor a counter, only the host syncs."""
    _, pi = plain
    qs = random_walks(8, 64, seed=11)
    runs = {}
    for every in (1, 16):
        monkeypatch.setattr(search_device, "STOP_CHECK_EVERY", every)
        runs[every] = exact_search_device_batch(
            pi, qs, K, chunk=256, metric="dtw", band=BAND, order=order,
            return_stats=True, device=CPU)
    for a, b in zip(runs[1][:3], runs[16][:3]):
        np.testing.assert_array_equal(a, b)
    syncs = {e: runs[e][3].pop("host_syncs") for e in runs}
    assert runs[1][3] == runs[16][3]
    assert syncs[16] < syncs[1]


def test_dtw_shares_the_ed_layout(plain):
    """DTW builds no second ``DeviceIndex``: after an ED and a DTW call the
    cache holds one layout."""
    _, pi = plain
    pi._device_cache.clear()
    pi._n_device_builds = 0
    qs = random_walks(3, 64, seed=5)
    exact_search_device_batch(pi, qs, K, device=CPU)
    exact_search_device_batch(pi, qs, K, metric="dtw", device=CPU)
    assert pi._n_device_builds == 1
    assert len(pi._device_cache) == 1


def test_cascade_counters_account_for_every_lane(fuzzy):
    _, pi = fuzzy
    qs = random_walks(6, 64, seed=9)
    for order in ORDERS:
        st = exact_search_device_batch(pi, qs, K, metric="dtw", band=BAND,
                                       order=order, return_stats=True,
                                       device=CPU)[3]
        assert st["considered"] > 0 and st["dp_survivors"] >= 0
        assert st["considered"] == sum(st[c] for c in COUNTERS[1:])
        assert st["killed_lb_improved"] > 0
        assert st["host_syncs"] >= 1
    ed = exact_search_device_batch(pi, qs, K, return_stats=True,
                                   device=CPU)[3]
    assert all(ed[c] == 0 for c in COUNTERS)
