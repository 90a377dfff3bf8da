"""The port's DeviceIndex against the reference's, field by field, for one
and four shards; the ``from_arrays`` carry-across; the tombstone, health
and cache behaviour (on the CPU, ``device="cpu"``)."""
import numpy as np
import pytest
import torch

from _torch_port import build_pair, torch_threads  # noqa: F401
from repro.core.device_index import DeviceIndex as RDev
from repro.core.device_index import _ARRAY_FIELDS as R_ARRAY_FIELDS
from repro.core.device_index import _META_FIELDS as R_META_FIELDS
from repro.data.series import random_walks
from repro_torch.core.device_index import (_ARRAY_FIELDS, _META_FIELDS,
                                           DeviceIndex)

CPU = "cpu"


@pytest.fixture(scope="module")
def plain():
    return build_pair(random_walks(3000, 64, seed=8))


@pytest.fixture(scope="module")
def fuzzy():
    return build_pair(random_walks(2500, 64, seed=2), fuzzy_f=0.15)


def _ref_arrays(rdev):
    return {f: np.asarray(getattr(rdev, f)) for f in R_ARRAY_FIELDS}


def _ref_meta(rdev):
    return {f: getattr(rdev, f) for f in R_META_FIELDS}


def _assert_same(rdev, pdev):
    for f in _ARRAY_FIELDS:
        a = np.asarray(getattr(rdev, f))
        b = getattr(pdev, f).cpu().numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in _META_FIELDS:
        assert getattr(rdev, f) == getattr(pdev, f), f


def test_field_lists_match_reference():
    assert _ARRAY_FIELDS == R_ARRAY_FIELDS
    assert _META_FIELDS == R_META_FIELDS


@pytest.mark.parametrize("layout", ["plain", "fuzzy"])
@pytest.mark.parametrize("S,chunk", [(1, 2048), (1, 256), (4, 300)])
def test_from_index_equals_reference(layout, S, chunk, request):
    ri, pi = request.getfixturevalue(layout)
    rdev = RDev.from_index(ri, chunk=chunk, n_shards=S)
    pdev = DeviceIndex.from_index(pi, chunk=chunk, n_shards=S, device=CPU)
    _assert_same(rdev, pdev)
    assert pdev.n_shards == S and pdev.device == torch.device(CPU)


@pytest.mark.parametrize("S", [1, 4])
def test_from_arrays_carries_the_reference_layout(plain, S):
    ri, _ = plain
    rdev = RDev.from_index(ri, chunk=512, n_shards=S)
    pdev = DeviceIndex.from_arrays(_ref_arrays(rdev), _ref_meta(rdev),
                                   device=CPU)
    _assert_same(rdev, pdev)
    with pytest.raises(ValueError, match="missing array fields"):
        DeviceIndex.from_arrays({"db": np.zeros((1, 1, 64), np.float32)},
                                _ref_meta(rdev), device=CPU)


def test_with_alive_and_shard_health_match_reference():
    ri, pi = build_pair(random_walks(1200, 64, seed=3), fuzzy_f=0.15)
    rdev = RDev.from_index(ri, chunk=256, n_shards=4)
    pdev = DeviceIndex.from_index(pi, chunk=256, n_shards=4, device=CPU)
    for v in (0, 10, 999):
        ri.delete(v)
        pi.delete(v)
    _assert_same(rdev.with_alive(ri.alive), pdev.with_alive(pi.alive))
    health = (True, False, True, True)
    assert pdev.with_shard_health(health).shard_health == \
        rdev.with_shard_health(health).shard_health == health
    assert pdev.with_shard_health((True,) * 4).shard_health is None
    with pytest.raises(ValueError, match="every shard dead"):
        pdev.with_shard_health((False,) * 4)
    with pytest.raises(ValueError, match="entries for 4 shards"):
        pdev.with_shard_health((True, False))


def test_device_index_cache_refresh_and_invalidation():
    _, pi = build_pair(random_walks(1000, 64, seed=6))
    dev = pi.device_index(chunk=256, device=CPU)
    assert pi.device_index(chunk=256, device=CPU) is dev
    assert pi._n_device_builds == 1
    victim = int(pi.flat.order[0])
    pi.delete(victim)
    dev2 = pi.device_index(chunk=256, device=CPU)
    assert pi._n_device_builds == 1          # tombstones refresh in place
    ids, alive = dev2.ids.numpy(), dev2.alive.numpy()
    assert not alive[ids == victim].any()
    assert alive[(ids >= 0) & (ids != victim)].all()
    pi.insert(random_walks(1, 64, seed=9)[0])
    dev3 = pi.device_index(chunk=256, device=CPU)
    assert pi._n_device_builds == 2          # inserts rebuild the layout
    assert dev3.total == dev.total + 1
