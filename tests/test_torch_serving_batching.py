"""The port's serving layer (``repro_torch.serving.batching`` and
``search_device.bucket_search_*``): a twin of every test in
``tests/test_serving_batching.py``, on the CPU (``device="cpu"``), plus the
port's buckets held against the reference's on the same data and knobs.

Tolerances.  Within the port, a coalesced mixed-knob bucket equals, lane by
lane and bitwise, the port's own ``extended_search_device_batch(
rerank=False)`` for each request issued alone: ids, distances and leaf
schedules, dead lanes, the fuzzy + tombstone layout and degraded shards.
Against the reference, the schedules are bitwise equal; ids and distances
are each package's own float32 sums, so distances agree within rtol 1e-5
and ids may swap only between distances tied within that rtol
(``assert_ties_only``)."""
import threading

import numpy as np
import pytest

from _torch_port import (assert_ties_only, build_pair,
                         torch_threads)  # noqa: F401
from repro.core import search_device as rsd
from repro.data.series import random_walks
from repro_torch.core import search_device as sd
from repro_torch.robustness import failpoints as fp
from repro_torch.serving.batching import (CoalescingFrontend, SearchResult,
                                          bucket_ladder)

N, LEN = 2000, 64
CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_registry():
    fp.REGISTRY.disarm()
    yield
    fp.REGISTRY.disarm()


@pytest.fixture(scope="module")
def pair():
    """(reference index, port index) over the same 2000 x 64 walks."""
    return build_pair(random_walks(N, LEN, seed=3), w=8, b=8, th=128)


@pytest.fixture(scope="module")
def idx(pair):
    return pair[1]


@pytest.fixture(scope="module")
def fuzzy_pair():
    """Fuzzy duplicates + tombstones: the layout where the dedup margin
    (``_result_margin``) and the alive mask actually bite.  Deletions are
    part of the fixture definition, not test-time mutation."""
    ri, pi = build_pair(random_walks(1200, LEN, seed=9), w=8, b=8, th=64,
                        fuzzy_f=0.15)
    assert pi.stats.n_duplicates > 0
    for i in range(60):
        ri.delete(i)
        pi.delete(i)
    return ri, pi


@pytest.fixture(scope="module")
def queries():
    return random_walks(8, LEN, seed=21).astype(np.float32)


def _individual(ix, q, k, nbr, metric, dev=None, shard_health=None):
    """The per-request reference: the port's batched path, one lane."""
    return sd.extended_search_device_batch(
        ix, q[None], k, nbr=nbr, metric=metric, rerank=False, dev=dev,
        shard_health=shard_health, device=CPU)


def _assert_lane_parity(ix, qs, ks, nbrs, mets, out, dev=None,
                        shard_health=None):
    ids, d, leaves = out[0], out[1], out[2]
    for i, (k, nbr, met) in enumerate(zip(ks, nbrs, mets)):
        if k == 0:                       # dead padding lane
            assert (ids[i] == -1).all() and np.isinf(d[i]).all()
            assert (leaves[i] == -1).all()
            continue
        ref = _individual(ix, qs[i], k, nbr, met, dev=dev,
                          shard_health=shard_health)
        assert np.array_equal(ids[i, :k], ref[0][0]), f"lane {i} ids"
        assert np.array_equal(d[i, :k], ref[1][0]), f"lane {i} dists"
        assert np.array_equal(leaves[i, :nbr], ref[2][0][:nbr]), \
            f"lane {i} schedule"
        assert (ids[i, k:] == -1).all() and np.isinf(d[i, k:]).all()
        assert (leaves[i, nbr:] == -1).all()


# -- bucket ladder + bucketed entry point --------------------------------------

def test_bucket_ladder():
    assert bucket_ladder(64) == (1, 2, 4, 8, 16, 32, 64)
    assert bucket_ladder(1) == (1,)
    assert bucket_ladder(5) == (1, 2, 4, 8)    # rounds the top up


MIXED = dict(ks=[1, 3, 10, 5, 0, 7], nbrs=[1, 2, 4, 3, 0, 4],
             mets=["ed", "dtw", "ed", "dtw", "ed", "ed"])


def _mixed_queries(queries):
    qs = queries[:6].copy()
    qs[4] = 0.0                                  # dead lane: finite pad
    return qs


def test_bucket_parity_mixed_knobs(idx, queries):
    """A coalesced mixed-k/nbr/metric bucket (with a dead padding lane) is
    lane-for-lane bitwise the individual extended path."""
    qs = _mixed_queries(queries)
    ids, d, leaves = sd.bucket_search_device_batch(
        idx, qs, MIXED["ks"], MIXED["nbrs"], MIXED["mets"], k_max=10,
        nbr_max=4, device=CPU)
    _assert_lane_parity(idx, qs, MIXED["ks"], MIXED["nbrs"], MIXED["mets"],
                        (ids, d, leaves))


FUZZY = dict(ks=[4, 8, 2, 6], nbrs=[2, 4, 1, 3],
             mets=["ed", "ed", "dtw", "ed"])


def test_bucket_parity_fuzzy_tombstones(fuzzy_pair, queries):
    ix = fuzzy_pair[1]
    out = sd.bucket_search_device_batch(
        ix, queries[:4], FUZZY["ks"], FUZZY["nbrs"], FUZZY["mets"], k_max=8,
        nbr_max=4, device=CPU)
    _assert_lane_parity(ix, queries[:4], FUZZY["ks"], FUZZY["nbrs"],
                        FUZZY["mets"], out)
    # tombstones actually excluded
    assert (out[0][out[0] >= 0] >= 60).all()


HEALTH = (True, False, True, True)
DEGRADED = dict(ks=[5, 3, 8], nbrs=[2, 4, 1], mets=["ed", "dtw", "ed"])


def test_bucket_parity_degraded(idx, queries):
    """Degraded mode: dead shards masked per lane exactly as in the
    individual path, coverage identical."""
    dev = idx.device_index(n_shards=4, device=CPU)
    out = sd.bucket_search_device_batch(
        idx, queries[:3], DEGRADED["ks"], DEGRADED["nbrs"], DEGRADED["mets"],
        k_max=8, nbr_max=4, dev=dev, shard_health=HEALTH)
    _assert_lane_parity(idx, queries[:3], DEGRADED["ks"], DEGRADED["nbrs"],
                        DEGRADED["mets"], out, dev=dev, shard_health=HEALTH)
    ref = _individual(idx, queries[0], 5, 2, "ed", dev=dev,
                      shard_health=HEALTH)
    assert 0.0 < out[3] < 1.0 and out[3] == ref[3]


def test_bucket_validation(idx, queries):
    def call(*a, **kw):
        return sd.bucket_search_device_batch(idx, *a, device=CPU, **kw)

    with pytest.raises(ValueError, match="one entry per query lane"):
        call(queries[:3], [5, 5], [2, 2, 2])
    with pytest.raises(ValueError, match="must be >= 0"):
        call(queries[:2], [5, -1], [2, 2])
    with pytest.raises(ValueError, match=r"lanes \[1\] request k > k_max=4"):
        call(queries[:2], [3, 9], [2, 2], k_max=4)
    with pytest.raises(ValueError, match="unknown metric"):
        call(queries[:2], [3, 3], [2, 2], ["ed", "l1"])
    bad = queries[:2].copy()
    bad[1, 0] = np.nan                   # same message as the batched path
    with pytest.raises(ValueError, match=r"queries \[1\] contain NaN/Inf"):
        call(bad, [3, 3], [2, 2])


# -- the port's buckets against the reference's --------------------------------

@pytest.mark.parametrize("case", ["mixed", "fuzzy", "degraded"])
def test_bucket_matches_reference_bucket(case, pair, fuzzy_pair, queries):
    """The same bucket through both packages: leaf schedules bitwise,
    ids and distances within rtol 1e-5 with only tied ids moving; dead
    lanes all ``-1 / inf`` in both, degraded coverage equal."""
    ri, pi = fuzzy_pair if case == "fuzzy" else pair
    knobs = {"mixed": MIXED, "fuzzy": FUZZY, "degraded": DEGRADED}[case]
    qs = {"mixed": _mixed_queries(queries), "fuzzy": queries[:4],
          "degraded": queries[:3]}[case]
    kw = dict(k_max=10 if case == "mixed" else 8, nbr_max=4)
    pkw, rkw = dict(kw), dict(kw)
    if case == "degraded":
        pkw.update(dev=pi.device_index(n_shards=4, device=CPU),
                   shard_health=HEALTH)
        rkw.update(dev=ri.device_index(n_shards=4), shard_health=HEALTH)
    else:
        pkw["device"] = CPU
    args = (qs, knobs["ks"], knobs["nbrs"], knobs["mets"])
    got = sd.bucket_search_device_batch(pi, *args, **pkw)
    want = rsd.bucket_search_device_batch(ri, *args, **rkw)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    assert_ties_only(got[0], got[1], np.asarray(want[0]),
                     np.asarray(want[1]))
    if case == "degraded":
        assert got[3] == want[3] and 0.0 < got[3] < 1.0


# -- coalescing front-end ------------------------------------------------------

def _frontend(ix, **kw):
    kw.setdefault("k_max", 8)
    kw.setdefault("nbr_max", 4)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait", 0.01)
    if "dev" not in kw:
        kw["device"] = CPU
    return CoalescingFrontend(ix, **kw)


def test_frontend_parity_and_stats(idx, queries):
    reqs = [(3, 1, "ed"), (8, 4, "dtw"), (1, 2, "ed"), (5, 3, "ed"),
            (2, 4, "dtw")]
    with _frontend(idx, max_wait=0.2) as fe:
        futs = [fe.submit(queries[i], k=k, nbr=nbr, metric=m)
                for i, (k, nbr, m) in enumerate(reqs)]
        res = [f.result(timeout=60) for f in futs]
    for i, ((k, nbr, m), r) in enumerate(zip(reqs, res)):
        assert isinstance(r, SearchResult)
        ref = _individual(idx, queries[i], k, nbr, m)
        assert r.ids.shape == (k,) and r.leaves.shape == (nbr,)
        assert np.array_equal(r.ids, ref[0][0])
        assert np.array_equal(r.d, ref[1][0])
        assert np.array_equal(r.leaves, ref[2][0][:nbr])
        assert r.coverage == 1.0 and r.t_done > 0
    s = fe.stats
    assert s.submitted == s.completed == 5 and s.failed == 0
    # a generous deadline coalesces the burst: 5 requests, max_batch 4
    assert s.batches <= 3 and s.live_lanes == 5
    assert s.snapshot()["mean_occupancy"] >= 1.0
    assert 0.0 <= s.padding_waste < 1.0


def test_frontend_nan_lane_isolated(idx, queries):
    """A NaN request fails *its own* future with exactly the individual
    path's error; coalesced neighbors complete normally."""
    bad = queries[0].copy()
    bad[3] = np.inf
    with _frontend(idx, max_wait=0.2) as fe:
        f_ok1 = fe.submit(queries[1], k=3, nbr=2)
        f_bad = fe.submit(bad, k=3, nbr=2)
        f_ok2 = fe.submit(queries[2], k=5, nbr=4, metric="dtw")
        with pytest.raises(ValueError, match=r"queries \[0\] contain "
                                             r"NaN/Inf values") as ei:
            f_bad.result(timeout=60)
        r1, r2 = f_ok1.result(timeout=60), f_ok2.result(timeout=60)
    with pytest.raises(ValueError) as ref_err:
        sd.extended_search_device_batch(idx, bad[None], 3, nbr=2,
                                        rerank=False, device=CPU)
    assert str(ei.value) == str(ref_err.value)   # identical attribution
    assert np.array_equal(r1.ids, _individual(idx, queries[1], 3, 2,
                                              "ed")[0][0])
    assert np.array_equal(r2.ids, _individual(idx, queries[2], 5, 4,
                                              "dtw")[0][0])
    assert fe.stats.failed == 1 and fe.stats.completed == 2


def test_frontend_degraded(idx, queries):
    dev = idx.device_index(n_shards=4, device=CPU)
    with _frontend(idx, dev=dev, shard_health=HEALTH) as fe:
        r = fe.submit(queries[0], k=5, nbr=2).result(timeout=60)
    ref = _individual(idx, queries[0], 5, 2, "ed",
                      dev=dev.with_shard_health(HEALTH))
    assert np.array_equal(r.ids, ref[0][0])
    assert 0.0 < r.coverage < 1.0 and r.coverage == ref[3]


def test_frontend_submit_validation(idx, queries):
    with _frontend(idx) as fe:
        with pytest.raises(ValueError, match=r"k=9 outside \[1, k_max=8\]"):
            fe.submit(queries[0], k=9)
        with pytest.raises(ValueError, match=r"nbr=0 outside"):
            fe.submit(queries[0], k=3, nbr=0)
        with pytest.raises(ValueError, match="unknown metric"):
            fe.submit(queries[0], k=3, metric="l2")
        with pytest.raises(ValueError, match="single query"):
            fe.submit(queries[:2], k=3)
        with pytest.raises(TypeError, match="real-numeric"):
            fe.submit(queries[0].astype(np.complex64), k=3)
        with pytest.raises(ValueError, match="length"):
            fe.submit(queries[0][:-1], k=3)
        assert fe.stats.submitted == 0
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit(queries[0], k=3)


def test_frontend_close_drains(idx, queries):
    """close() flushes partial buckets immediately and completes every
    queued future — even ones that never met the deadline."""
    fe = _frontend(idx, max_wait=30.0)          # deadline far away
    futs = [fe.submit(queries[i], k=2 + i, nbr=1 + i % 4) for i in range(3)]
    fe.close(timeout=60)
    for i, f in enumerate(futs):
        r = f.result(timeout=1)                 # already done
        assert np.array_equal(
            r.ids, _individual(idx, queries[i], 2 + i, 1 + i % 4,
                               "ed")[0][0])
    assert fe.stats.completed == 3


def test_frontend_concurrent_submitters(idx, queries):
    """Requests from several threads coalesce into shared buckets and every
    future resolves to its own lane's answer."""
    results = {}
    with _frontend(idx, max_wait=0.05, max_batch=8) as fe:
        def client(i):
            results[i] = fe.submit(queries[i], k=2 + i, nbr=1 + i % 4) \
                .result(timeout=60)
        ts = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    for i in range(6):
        ref = _individual(idx, queries[i], 2 + i, 1 + i % 4, "ed")
        assert np.array_equal(results[i].ids, ref[0][0])
    assert fe.stats.completed == 6 and fe.stats.batches <= 6


def test_frontend_stress_many_submitters(idx, queries):
    """More submitter threads than cores, with a short interpreter switch
    interval: every request completes with its own lane's answer and no
    counter update is lost."""
    import sys
    ref = {i: _individual(idx, queries[i], 3, 1 + i % 4, "ed")[0][0]
           for i in range(8)}
    got, errors = [], []
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _frontend(idx, max_wait=0.002, max_batch=8) as fe:
            def client(t):
                for j in range(4):
                    i = (t + j) % 8
                    try:
                        r = fe.submit(queries[i], k=3, nbr=1 + i % 4
                                      ).result(timeout=60)
                        got.append((i, r.ids))
                    except Exception as e:      # noqa: BLE001 - reported
                        errors.append(e)
            ts = [threading.Thread(target=client, args=(t,))
                  for t in range(16)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(prev)
    assert not errors and len(got) == 64
    for i, ids in got:
        assert np.array_equal(ids, ref[i])
    s = fe.stats
    assert s.submitted == s.completed == 64 and s.failed == 0
    assert s.live_lanes == 64 and s.lanes >= 64


# -- failpoints / graceful degradation ----------------------------------------

def test_enqueue_failpoint(idx, queries):
    with _frontend(idx) as fe:
        with fp.armed({"serving.enqueue": "raise"}):
            with pytest.raises(fp.FailpointError):
                fe.submit(queries[0])
        r = fe.submit(queries[0], k=3, nbr=2).result(timeout=60)
        assert r.ids.shape == (3,)
    assert fe.stats.submitted == 1 and fe.stats.failed == 0


def test_flush_flaky_is_retried(idx, queries):
    """A transient flush fault is retried transparently — the request still
    completes and nothing is marked failed."""
    with _frontend(idx) as fe:
        with fp.armed({"serving.flush": "flaky:1"}):
            r = fe.submit(queries[0], k=4, nbr=2).result(timeout=60)
    assert np.array_equal(r.ids, _individual(idx, queries[0], 4, 2,
                                             "ed")[0][0])
    assert fe.stats.completed == 1 and fe.stats.failed == 0


def test_flush_exhausted_fails_bucket_only(idx, queries):
    """Retries exhausted fails that bucket's futures; the front-end keeps
    serving the next traffic."""
    with _frontend(idx) as fe:
        with fp.armed({"serving.flush": "raise"}):
            f = fe.submit(queries[0], k=3, nbr=2)
            with pytest.raises((fp.FailpointError, fp.RetriesExhausted)):
                f.result(timeout=60)
        r = fe.submit(queries[1], k=3, nbr=2).result(timeout=60)
    assert np.array_equal(r.ids, _individual(idx, queries[1], 3, 2,
                                             "ed")[0][0])
    assert fe.stats.failed == 1 and fe.stats.completed == 1


def test_flush_crash_kills_dispatcher(idx, queries):
    """An injected crash (BaseException) takes the dispatcher down: every
    orphan future fails with the cause chained, and later submits raise."""
    fe = _frontend(idx)
    with fp.armed({"serving.flush": "crash"}):
        f = fe.submit(queries[0], k=3, nbr=2)
        with pytest.raises(RuntimeError, match="dispatcher died") as ei:
            f.result(timeout=60)
    assert isinstance(ei.value.__cause__, fp.InjectedCrash)
    fe._thread.join(timeout=60)
    with pytest.raises(RuntimeError, match="dispatcher died"):
        fe.submit(queries[1])
    assert fe.stats.failed == 1


# -- what the port adds: entry points on CUDA by default -----------------------

def test_frontend_defaults_to_cuda(idx):
    """Without ``device`` or ``dev`` the front-end serves the CUDA layout,
    and raises where there is none (nothing runs on the CPU instead)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    builds = idx._n_device_builds
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CoalescingFrontend(idx, max_batch=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sd.bucket_search_device_batch(idx, np.zeros((1, LEN), np.float32),
                                      [3], [2])
    assert idx._n_device_builds == builds
