"""The port's exact search (ED; DTW in ``test_torch_dtw_search.py``)
against the reference's
``exact_search_device_batch`` and the host ``exact_search``: ids and
distances bitwise, ``spans_visited`` equal, on plain and fuzzy layouts with
tombstones, for one and four shards (on the CPU, ``device="cpu"``)."""
import numpy as np
import pytest

from _torch_port import build_pair, torch_threads  # noqa: F401
from repro.core.device_index import DeviceIndex as RDev
from repro.core.search import exact_search
from repro.core.search_device import exact_search_device as r_single
from repro.core.search_device import exact_search_device_batch as r_batch
from repro.data.series import random_walks
from repro_torch.core import search_device
from repro_torch.core.search_device import (exact_search_device,
                                            exact_search_device_batch)

CPU = "cpu"
K = 10
CHUNK = 256
VICTIMS = (5, 17, 300, 1111)


@pytest.fixture(scope="module")
def plain():
    ri, pi = build_pair(random_walks(4000, 64, seed=0))
    return _tombstone(ri, pi)


@pytest.fixture(scope="module")
def fuzzy():
    ri, pi = build_pair(random_walks(2500, 64, seed=2), fuzzy_f=0.15)
    assert pi.stats.n_duplicates > 0
    return _tombstone(ri, pi)


def _tombstone(ri, pi):
    for v in VICTIMS:
        ri.delete(v)
        pi.delete(v)
    return ri, pi


def _ref(ri, qs, k, S, chunk=CHUNK, **kw):
    dev = RDev.from_index(ri, chunk=chunk, n_shards=S)
    return r_batch(ri, qs, k, dev=dev, **kw)


@pytest.mark.parametrize("layout", ["plain", "fuzzy"])
@pytest.mark.parametrize("S", [1, 4])
def test_exact_batch_bitwise_equals_reference_and_host(layout, S, request):
    ri, pi = request.getfixturevalue(layout)
    qs = random_walks(16, 64, seed=31)
    ids, d, vis = exact_search_device_batch(pi, qs, K, chunk=CHUNK,
                                            n_shards=S, device=CPU)
    r_ids, r_d, r_vis = _ref(ri, qs, K, S)
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_array_equal(d, r_d)
    np.testing.assert_array_equal(vis, r_vis)
    assert d.dtype == r_d.dtype and ids.dtype == r_ids.dtype
    assert not np.isin(ids, VICTIMS).any()
    for i, q in enumerate(qs):
        h_ids, h_d, _ = exact_search(ri, q, K)
        np.testing.assert_array_equal(ids[i], h_ids)
        np.testing.assert_array_equal(d[i], h_d)


def test_shard_count_invariance(fuzzy):
    _, pi = fuzzy
    qs = random_walks(8, 64, seed=13)
    base = exact_search_device_batch(pi, qs, K, chunk=CHUNK, device=CPU)
    for S in (2, 3, 4):
        got = exact_search_device_batch(pi, qs, K, chunk=CHUNK, n_shards=S,
                                        device=CPU)
        np.testing.assert_array_equal(got[0], base[0])
        np.testing.assert_array_equal(got[1], base[1])


def test_k_larger_than_alive_pads():
    db = random_walks(60, 64, seed=3)
    ri, pi = build_pair(db)
    for v in range(0, 60, 3):
        ri.delete(v)
        pi.delete(v)
    qs = random_walks(3, 64, seed=4)
    ids, d, vis = exact_search_device_batch(pi, qs, 50, device=CPU)
    r_ids, r_d, r_vis = r_batch(ri, qs, 50)
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_array_equal(d, r_d)
    np.testing.assert_array_equal(vis, r_vis)
    assert (ids[:, 40:] == -1).all() and np.isinf(d[:, 40:]).all()
    assert ((ids[:, :40] >= 0) & (ids[:, :40] % 3 != 0)).all()


def test_batch_of_one_matches_reference(plain):
    ri, pi = plain
    q = random_walks(1, 64, seed=5)[0]
    got = exact_search_device(pi, q, K, chunk=CHUNK, device=CPU)
    want = r_single(ri, q, K, chunk=CHUNK)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_degraded_mode_matches_reference(plain):
    ri, pi = plain
    qs = random_walks(6, 64, seed=7)
    health = (True, False, True, True)
    ids, d, vis, cov = exact_search_device_batch(
        pi, qs, K, chunk=CHUNK, n_shards=4, shard_health=health, device=CPU)
    r_ids, r_d, r_vis, r_cov = _ref(ri, qs, K, 4, shard_health=health)
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_array_equal(d, r_d)
    np.testing.assert_array_equal(vis, r_vis)
    assert cov == r_cov and 0.0 < cov < 1.0


def test_stop_test_interval_does_not_change_results(plain, monkeypatch):
    """Testing the stop condition every G spans instead of every span is
    exact: spans run after the condition turned false merge nothing."""
    _, pi = plain
    qs = random_walks(8, 64, seed=11)
    monkeypatch.setattr(search_device, "STOP_CHECK_EVERY", 1)
    each = exact_search_device_batch(pi, qs, K, chunk=64, device=CPU,
                                     return_stats=True)
    monkeypatch.setattr(search_device, "STOP_CHECK_EVERY", 16)
    grouped = exact_search_device_batch(pi, qs, K, chunk=64, device=CPU,
                                        return_stats=True)
    for a, b in zip(each[:3], grouped[:3]):
        np.testing.assert_array_equal(a, b)
    W = pi.device_index(chunk=64, device=CPU).win_start.shape[1]
    assert grouped[3]["host_syncs"] <= 1 + -(-W // 16)
    assert grouped[3]["host_syncs"] < each[3]["host_syncs"]


@pytest.mark.parametrize("bad,exc,msg", [
    (np.full((2, 64), np.nan), ValueError, "contain NaN/Inf"),
    (np.zeros((2, 63)), ValueError, "query length 63"),
    (np.zeros((2, 2, 64)), ValueError, "must be \\[Q, n\\]"),
    (np.array([["a"] * 64]), TypeError, "real-numeric"),
])
def test_validation_errors_match_reference(plain, bad, exc, msg):
    ri, pi = plain
    with pytest.raises(exc, match=msg) as got:
        exact_search_device_batch(pi, bad, K, device=CPU)
    with pytest.raises(exc) as want:
        r_batch(ri, bad, K)
    assert str(got.value) == str(want.value)


def test_dtw_waits_for_its_slice(plain):
    """DTW, which an earlier slice refused, now runs: the port's default
    DTW search (band 0.1 n, order "cluster") equals the reference's."""
    ri, pi = plain
    qs = random_walks(2, 64, seed=1)
    got = exact_search_device_batch(pi, qs, K, chunk=CHUNK, metric="dtw",
                                    device=CPU)
    want = _ref(ri, qs, K, 1, metric="dtw")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    ids, d, _ = exact_search_device(pi, qs[0], K, chunk=CHUNK, metric="dtw",
                                    device=CPU)
    r_ids, r_d, _ = r_single(ri, qs[0], K, chunk=CHUNK, metric="dtw")
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_array_equal(d, r_d)
