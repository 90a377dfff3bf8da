"""The port's device build (``backend="device"``, ``core/build_device.py``)
against its host build and the reference's ``device_build``: layout parity
on plain, skewed and fuzzy data, the ordered rows on the device, the
``DeviceIndex`` assembled from them, the encoders, and save/load after
updates.  Runs on the CPU (``device="cpu"``)."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import (clear_of_breakpoints, params_pair,  # noqa: F401
                         torch_threads)
from repro.core import build_device as r_bd
from repro.data.series import clustered_series
from repro_torch.core import build_device as bd
from repro_torch.core.build import DumpyParams
from repro_torch.core.device_index import DeviceIndex
from repro_torch.core.index import DumpyIndex
from repro_torch.core.sax import SaxParams, sax_encode_np
from repro_torch.core.search import exact_search
from repro_torch.core.split import SplitParams
from repro_torch.data.series import random_walks

CPU = "cpu"
PARAMS = DumpyParams(sax=SaxParams(w=8, b=8), split=SplitParams(th=128))
ROUTING_FIELDS = ("node_csl", "node_shift", "node_lam", "edge_parent",
                  "edge_sid", "edge_leaf", "edge_child", "edge_nl",
                  "edge_begin", "edge_end", "node_begin", "node_end",
                  "leaf_parent", "grp_off", "grp_begin", "grp_end")
KINDS = [("rand", 0.0), ("skew", 0.0), ("rand_fuzzy", 0.15),
         ("skew_fuzzy", 0.15)]


def _dataset(kind: str, n: int = 6000, length: int = 64) -> np.ndarray:
    if kind.startswith("skew"):
        return clustered_series(n, length, n_clusters=6, seed=11)
    return random_walks(n, length, seed=11)


def _kind_params(fuzzy: float):
    """``(reference, port)`` parameters of the parity datasets."""
    rp, pp = params_pair(th=128, fuzzy_f=fuzzy)
    return (dataclasses.replace(rp, max_replica=3),
            dataclasses.replace(pp, max_replica=3))


def _assert_same_layout(a, b, plans: bool = True) -> None:
    """Layout, routing and stats of two indexes or build results (of
    either package).  ``plans=False`` leaves out ``plans_evaluated``: the
    host backend evaluates split plans per row, the device backend per
    word group, so the two backends count differently."""
    for f in ("order", "leaf_offsets", "leaf_sym", "leaf_card", "leaf_lo",
              "leaf_hi"):
        x, y = getattr(a.flat, f), getattr(b.flat, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    if hasattr(a, "routing_flat"):
        ra, rb = a.routing_flat, b.routing_flat
        for f in ROUTING_FIELDS:
            np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f),
                                          err_msg=f)
    sa, sb = dataclasses.asdict(a.stats), dataclasses.asdict(b.stats)
    if not plans:
        sa.pop("plans_evaluated")
        sb.pop("plans_evaluated")
    assert sa == sb


# -- host vs device backend parity -------------------------------------------

@pytest.mark.parametrize("kind,fuzzy", KINDS)
def test_backend_layout_parity(kind, fuzzy):
    db = _dataset(kind)
    _, params = _kind_params(fuzzy)
    host = DumpyIndex.build(db, params)
    dev = DumpyIndex.build(db, params, backend="device", device=CPU)
    _assert_same_layout(host, dev, plans=False)
    np.testing.assert_array_equal(host.paa, dev.paa)
    np.testing.assert_array_equal(host.sax, dev.sax)
    if fuzzy:
        assert dev.stats.n_duplicates > 0


@pytest.mark.parametrize("kind,fuzzy", KINDS)
def test_device_build_equals_reference(kind, fuzzy):
    """The port's ``device_build`` with the ``np`` encoder gives the
    reference's ``device_build`` layout, tree and summaries bitwise."""
    db = _dataset(kind)
    rp, pp = _kind_params(fuzzy)
    want = r_bd.device_build(db, rp)
    got = bd.device_build(db, pp, device=CPU)
    _assert_same_layout(got, want)
    np.testing.assert_array_equal(got.order, want.order)
    np.testing.assert_array_equal(got.paa, want.paa)
    np.testing.assert_array_equal(got.sax, want.sax)
    np.testing.assert_array_equal(got.db_ordered_dev.numpy(),
                                  np.asarray(want.db_ordered_dev))


def test_backend_parity_tiny_collection():
    """n <= th: both backends produce the single root leaf."""
    db = random_walks(50, 64, seed=4)
    host = DumpyIndex.build(db, PARAMS)
    dev = DumpyIndex.build(db, PARAMS, backend="device", device=CPU)
    _assert_same_layout(host, dev, plans=False)
    assert dev.flat.n_leaves == 1
    np.testing.assert_array_equal(dev.flat.order, np.arange(50))
    np.testing.assert_array_equal(dev._db_ordered_dev.numpy(), db)


def test_lexsort_words_matches_reference():
    """Stage 2 (stable sorts on the device) gives the reference's
    ``jnp.lexsort`` permutation, group flags and row → word map, on words
    with many repeats and keys in two packed columns."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (300, 8)).astype(np.uint8)
    sax = base[rng.integers(0, 300, 5000)]
    perm, flags, row2word = bd._lexsort_words(torch.from_numpy(sax), 8, 8)
    import jax.numpy as jnp
    r_perm, r_flags, r_row2word = r_bd._lexsort_words(jnp.asarray(sax), 8, 8)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(r_perm))
    np.testing.assert_array_equal(flags.numpy(), np.asarray(r_flags))
    np.testing.assert_array_equal(row2word.numpy(), np.asarray(r_row2word))


def test_device_backend_db_ordered_matches_device_copy():
    """The device-resident ordered collection is the ordered host db."""
    db = _dataset("rand", 3000)
    dev = DumpyIndex.build(db, PARAMS, backend="device", device=CPU)
    assert isinstance(dev._db_ordered_dev, torch.Tensor)
    np.testing.assert_array_equal(dev._db_ordered_dev.numpy(),
                                  db[dev.flat.order])


@pytest.mark.parametrize("S", [1, 4])
def test_device_index_from_device_build_matches_host_path(S):
    """A DeviceIndex assembled from the rows already on the device equals
    the one assembled through the host ``db_ordered``, field by field, and
    the host permutation is never materialized on the way."""
    db = _dataset("rand", 3000)
    dev = DumpyIndex.build(db, PARAMS, backend="device", device=CPU)
    via_device = dev.device_index(chunk=512, n_shards=S, device=CPU)
    assert dev._db_ordered is None
    via_host = DeviceIndex.from_index(dev, chunk=512, n_shards=S, device=CPU)
    for f in dataclasses.fields(DeviceIndex):
        a, b = getattr(via_device, f.name), getattr(via_host, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f.name)
        else:
            assert a == b, f.name


def test_insert_drops_the_device_rows():
    db = _dataset("rand", 3000)
    idx = DumpyIndex.build(db, PARAMS, backend="device", device=CPU)
    idx.device_index(chunk=512, device=CPU)
    idx.insert_many(random_walks(40, 64, seed=3))
    assert idx._db_ordered_dev is None and not idx._device_cache
    after = idx.device_index(chunk=512, device=CPU)
    np.testing.assert_array_equal(after.db[0, :len(idx.flat.order)].numpy(),
                                  idx.db[idx.flat.order])


def test_unknown_backend_and_encoder_rejected():
    with pytest.raises(ValueError, match="unknown build backend"):
        DumpyIndex.build(random_walks(10, 64), PARAMS, backend="gpu")
    with pytest.raises(ValueError, match="unknown encoder"):
        bd.device_build(random_walks(300, 64), PARAMS, encoder="pallas",
                        device=CPU)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")


def test_device_backend_defaults_to_cuda(no_cuda):
    db = random_walks(300, 64, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DumpyIndex.build(db, PARAMS, backend="device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bd.device_build(db, PARAMS)
    DumpyIndex.build(db, PARAMS)            # the host backend needs no card


# -- the float32 encoders ------------------------------------------------------

def _clear_data(n: int, seed: int) -> np.ndarray:
    """Random walks whose float64 PAA lies clear of every breakpoint, so
    that any summation order gives the same symbols."""
    db = random_walks(n, 64, seed=seed)
    paa, _ = sax_encode_np(db, PARAMS.sax)
    return db[clear_of_breakpoints(paa, 8).all(axis=1)]


@pytest.mark.parametrize("r_encoder", ["jnp", "pallas"])
def test_float32_encoders_match_reference(r_encoder):
    """``kernel`` (its plain twin on the CPU) against each of the
    reference's float32 encoders, ``jnp`` and ``pallas`` (interpret mode):
    the same symbols and layout, the PAA within float32 rounding; and the
    host build's layout, since no symbol is borderline."""
    db = _clear_data(3000, seed=12)
    rp, pp = params_pair(th=128)
    got = bd.device_build(db, pp, encoder="kernel", device=CPU)
    want = r_bd.device_build(db, rp, encoder=r_encoder)
    np.testing.assert_array_equal(got.sax, want.sax)
    np.testing.assert_allclose(got.paa, want.paa, rtol=1e-5, atol=1e-5)
    assert got.sax.dtype == np.uint8 and got.paa.dtype == np.float32
    _assert_same_layout(got, want)
    host = DumpyIndex.build(db, pp)
    np.testing.assert_array_equal(got.sax, host.sax)
    np.testing.assert_array_equal(got.flat.order, host.flat.order)
    np.testing.assert_array_equal(got.flat.leaf_offsets,
                                  host.flat.leaf_offsets)


# -- persistence after update sequences ----------------------------------------

@pytest.mark.parametrize("backend", ["host", "device"])
def test_save_load_roundtrip_after_updates(tmp_path, backend):
    db = random_walks(3000, 64, seed=21)
    params = DumpyParams(sax=SaxParams(w=8, b=8), split=SplitParams(th=128),
                         fuzzy_f=0.1, max_replica=2)
    idx = DumpyIndex.build(db, params, backend=backend, device=CPU)
    idx.insert_many(random_walks(400, 64, seed=22))
    for sid in (3, 100, 2999, 3100):
        idx.delete(sid)
    # force enough clustered inserts to trigger at least one resplit
    nearby = db[42] + 1e-3 * random_walks(200, 64, seed=23)
    idx.insert_many(nearby)

    path = str(tmp_path / "idx")
    idx.save(path)
    idx2 = DumpyIndex.load(path)
    np.testing.assert_array_equal(idx2.db, idx.db)
    np.testing.assert_array_equal(idx2.alive, idx.alive)
    for f in ("order", "leaf_offsets", "leaf_sym", "leaf_card"):
        np.testing.assert_array_equal(getattr(idx2.flat, f),
                                      getattr(idx.flat, f), err_msg=f)
    # the loaded index still answers exact queries over live series
    q = random_walks(1, 64, seed=77)[0]
    alive_ids = np.flatnonzero(idx.alive)
    d = np.sqrt(((idx.db[alive_ids] - q) ** 2).sum(-1))
    gt = alive_ids[np.argsort(d, kind="stable")[:5]]
    got, _, _ = exact_search(idx2, q, 5)
    np.testing.assert_array_equal(np.sort(gt), np.sort(got))
