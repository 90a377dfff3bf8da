"""The index lifecycle on the card: the device build with each encoder,
save and load of an index searched on the card, and the robustness smoke.
Imports no ``jax``, so it runs where the card is::

    python -m pytest -q -m cuda tests/test_torch_lifecycle_cuda.py

everywhere else every case skips with a reason.

Tolerances: layouts bitwise equal to the host build where no symbol
differs from ``sax_encode_np`` (float32 PAA sums may put a borderline
mean on the other side of a breakpoint; then every leaf's rows must lie in
its SAX region); search results before and after a save/load bitwise."""
import numpy as np
import pytest
import torch

from _torch_port import cuda, torch_threads  # noqa: F401
from repro_torch.core.build import DumpyParams
from repro_torch.core.build_device import device_build
from repro_torch.core.device_index import DeviceIndex
from repro_torch.core.index import DumpyIndex
from repro_torch.core.sax import SaxParams
from repro_torch.core.search_device import exact_search_device_batch
from repro_torch.core.split import SplitParams
from repro_torch.data.series import random_walks
from repro_torch.kernels import sax_encode
from repro_torch.robustness import failpoints as fp
from repro_torch.robustness import smoke

pytestmark = pytest.mark.cuda

PARAMS = DumpyParams(sax=SaxParams(w=16, b=8), split=SplitParams(th=500))


@pytest.fixture(autouse=True)
def _clean_registry():
    fp.REGISTRY.disarm()
    yield
    fp.REGISTRY.disarm()


@pytest.fixture(scope="module")
def db():
    return random_walks(40_000, 256, seed=5)


@pytest.fixture(scope="module")
def host(db):
    return DumpyIndex.build(db, PARAMS)


def _rows_in_their_leaves(res) -> bool:
    """Every row of every leaf lies in the leaf's SAX region, by the
    build's own symbols."""
    flat, b = res.flat, PARAMS.sax.b
    leaf = np.repeat(np.arange(flat.n_leaves), np.diff(flat.leaf_offsets))
    card = flat.leaf_card[leaf].astype(np.int64)
    prefix = res.sax[flat.order].astype(np.int64) >> (b - card)
    return bool((prefix == flat.leaf_sym[leaf]).all())


@pytest.mark.parametrize("encoder", ["np", "kernel"])
def test_device_build_on_card(cuda, db, host, encoder):
    launches = sax_encode.launches
    res = device_build(db, PARAMS, encoder=encoder, device=cuda)
    assert (sax_encode.launches > launches) == (encoder == "kernel")
    assert res.db_ordered_dev.device.type == cuda.type
    np.testing.assert_array_equal(res.db_ordered_dev.cpu().numpy(),
                                  db[res.order])
    assert _rows_in_their_leaves(res)
    if encoder == "np" or np.array_equal(res.sax, host.sax):
        for f in ("order", "leaf_offsets", "leaf_sym", "leaf_card"):
            np.testing.assert_array_equal(getattr(res.flat, f),
                                          getattr(host.flat, f), err_msg=f)
        assert res.stats.n_leaves == host.stats.n_leaves


def test_device_index_from_rows_on_card(cuda, db, host):
    idx = DumpyIndex.build(db, PARAMS, backend="device", device=cuda)
    via_rows = idx.device_index(chunk=2048, device=cuda)
    assert idx._db_ordered is None          # no host permutation
    want = host.device_index(chunk=2048, device=cuda)
    for f in ("db", "ids", "alive", "leaf_start", "leaf_lo_g", "rt_sid"):
        assert torch.equal(getattr(via_rows, f), getattr(want, f)), f
    via_host = DeviceIndex.from_index(idx, chunk=700, n_shards=4,
                                      device=cuda)
    via_rows4 = DeviceIndex.from_index(idx, chunk=700, n_shards=4,
                                       device=cuda,
                                       db_device=idx._db_ordered_dev)
    assert torch.equal(via_host.db, via_rows4.db)


def test_save_load_search_bitwise_on_card(cuda, db, tmp_path):
    idx = DumpyIndex.build(db, PARAMS)
    qs = random_walks(16, 256, seed=9)
    ids, d, _ = exact_search_device_batch(idx, qs, 10, device=cuda)
    path = str(tmp_path / "idx")
    idx.save(path)
    re = DumpyIndex.load(path)
    assert re._n_device_builds == 0 and not re._device_cache
    ids2, d2, _ = exact_search_device_batch(re, qs, 10, device=cuda)
    assert re._n_device_builds == 1
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_array_equal(d, d2)
    # an insert logged to the WAL survives a crashed overwrite
    new = random_walks(8, 256, seed=10)
    re.insert_many(new)
    with fp.armed({"index.save.commit": "crash"}):
        with pytest.raises(fp.InjectedCrash):
            re.save(path)
    back = DumpyIndex.load(path)
    np.testing.assert_array_equal(back.db, re.db)
    ids3, d3, _ = exact_search_device_batch(back, new, 1, device=cuda)
    np.testing.assert_array_equal(ids3[:, 0], np.arange(40_000, 40_008))
    assert (d3[:, 0] == 0).all()


def test_robustness_smoke_on_card(cuda, capsys):
    assert smoke.crash_on_commit_smoke(device="cuda")
    assert smoke.degraded_search_smoke(device="cuda")
    assert "FAIL" not in capsys.readouterr().out
