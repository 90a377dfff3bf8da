"""The serving path on the card: mixed-knob buckets against the port's own
individual extended search, the five kernels a bucket launches at a
one-lane bucket's shapes against their plain versions, and a bucket launch
that never waits for the device.  Imports no ``jax``, so it runs where the
card is::

    python -m pytest -q -m cuda tests/test_torch_serving_cuda.py

everywhere else every case skips with a reason.

Tolerances: leaf schedules, ids and distances bitwise per lane (the bucket
and the lone request sum each ED distance in the same order);
``lb_paa_interval`` and ``sax_encode`` bitwise against their in-order sums,
``dtw_band`` bitwise against its twin, ``lb_keogh`` and ``lb_improved``
within rtol 1e-5 of theirs (phase 4 of ``chip_smoke.py``)."""
import contextlib

import numpy as np
import pytest
import torch

from _torch_port import cuda, torch_threads  # noqa: F401
from repro_torch.core import search_device as sd
from repro_torch.core.build import DumpyParams
from repro_torch.core.index import DumpyIndex
from repro_torch.core.sax import SaxParams
from repro_torch.core.split import SplitParams
from repro_torch.data.series import random_walks
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

LEN, K_MAX, NBR_MAX = 64, 10, 4
FIVE = ("sax_encode", "lb_paa_interval", "lb_keogh", "lb_improved",
        "dtw_band")


@pytest.fixture(scope="module")
def index():
    db = random_walks(2000, LEN, seed=3)
    return DumpyIndex.build(db, DumpyParams(sax=SaxParams(w=8, b=8),
                                            split=SplitParams(th=128)))


@pytest.fixture(scope="module")
def queries():
    return random_walks(16, LEN, seed=21).astype(np.float32)


def _knobs(Q):
    ks = [1 + i % K_MAX for i in range(Q)]
    nbrs = [1 + i % NBR_MAX for i in range(Q)]
    mets = ["dtw" if i % 4 == 3 else "ed" for i in range(Q)]
    return ks, nbrs, mets


@pytest.mark.parametrize("Q", [1, 2, 16])
def test_bucket_equals_individual_on_card(cuda, index, queries, Q):
    dev = index.device_index(device=cuda)
    qs = queries[:Q].copy()
    ks, nbrs, mets = _knobs(Q)
    if Q > 2:
        ks[5], qs[5] = 0, 0.0                   # a dead lane
    ids, d, leaves = sd.bucket_search_device_batch(
        index, qs, ks, nbrs, mets, k_max=K_MAX, nbr_max=NBR_MAX, dev=dev)
    for i, (k, nbr, m) in enumerate(zip(ks, nbrs, mets)):
        if k == 0:
            assert (ids[i] == -1).all() and (leaves[i] == -1).all()
            continue
        r_ids, r_d, r_leaves = sd.extended_search_device_batch(
            index, qs[i:i + 1], k, nbr=nbr, metric=m, rerank=False, dev=dev)
        np.testing.assert_array_equal(leaves[i, :nbr], r_leaves[0][:nbr])
        np.testing.assert_array_equal(ids[i, :k], r_ids[0])
        np.testing.assert_array_equal(d[i, :k], r_d[0])


@contextlib.contextmanager
def _recorded():
    """Record the arguments of every call of the five kernels' dispatchers
    (``kernels.ops``) while the block runs."""
    calls = {name: [] for name in FIVE}
    real = {name: getattr(ops, name) for name in FIVE}

    def recorder(name):
        def call(*a, **kw):
            calls[name].append((a, kw))
            return real[name](*a, **kw)
        return call

    for name in FIVE:
        setattr(ops, name, recorder(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)


def _check_call(name, a, kw):
    got = getattr(ops, name)(*a, **kw)
    if name == "sax_encode":
        paa, sym = ref.sax_encode_in_order(*a)
        assert torch.equal(got[0], paa) and torch.equal(got[1].long(), sym)
    elif name == "lb_paa_interval":
        assert torch.equal(got, ref.lb_paa_interval_in_order(*a))
    elif name == "dtw_band":
        assert torch.equal(got, ref.dtw_band_ref(*a, **kw))
    else:
        want = getattr(ref, f"{name}_ref")(*a)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_five_kernels_at_a_one_lane_bucket(cuda, index, queries):
    """A one-lane DTW bucket launches each of the five kernels; each call,
    replayed, agrees with its plain version."""
    dev = index.device_index(device=cuda)
    qs = torch.from_numpy(queries[:1]).to(cuda)
    with _recorded() as calls:
        res = sd.bucket_search_launch(index, qs, [NBR_MAX], [True],
                                      k_max=K_MAX, nbr_max=NBR_MAX, dev=dev)
        torch.cuda.synchronize()
    assert res[0].shape[0] == 1
    for name in FIVE:
        assert calls[name], f"{name} was not launched"
        for a, kw in calls[name]:
            _check_call(name, a, kw)


def test_launch_never_waits_for_the_device(cuda, index, queries):
    """``bucket_search_launch`` runs under ``set_sync_debug_mode("error")``
    — any device→host wait inside it raises — for a pure-ED, a mixed and
    a degraded bucket; the harvest then gives the blocking path's answer."""
    dev4 = index.device_index(n_shards=4, device=cuda).with_shard_health(
        (True, False, True, True))
    qs = torch.from_numpy(queries).to(cuda)
    ks, nbrs, mets = _knobs(len(queries))
    lane_dtw = np.array([m == "dtw" for m in mets])
    dev1 = index.device_index(device=cuda)
    for dev, dtw in ((dev1, np.zeros_like(lane_dtw)), (dev1, lane_dtw),
                     (dev4, lane_dtw)):
        kw = dict(k_max=K_MAX, nbr_max=NBR_MAX, dev=dev)
        sd.bucket_search_launch(index, qs, nbrs, dtw, **kw)    # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = sd.bucket_search_launch(index, qs, nbrs, dtw, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = sd.bucket_search_finish(res, ks, nbrs, k_max=K_MAX)
        want = sd.bucket_search_device_batch(
            index, queries, ks, nbrs, dtw, k_max=K_MAX, nbr_max=NBR_MAX,
            dev=dev)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
