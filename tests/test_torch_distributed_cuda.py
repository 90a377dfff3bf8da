"""The distributed slice on the card: ``pairwise_l2`` at the collection-wide
width of ``search_step``, ``build_step`` and ``search_step`` on the card
against their CPU runs, and a mesh that spans two devices (the card and the
CPU, the one way to put two shards on different devices on a one-card
machine), and, where two cards are visible, a mesh over two cards and every
kernel on the second card.  Imports no ``jax``, so it runs where the card
is::

    python -m pytest -q -m cuda tests/test_torch_distributed_cuda.py

everywhere else every case skips with a reason.

Tolerances: ``pairwise_l2`` within 1e-5·(|q|² + |x|²) of its twin and
bitwise the same pairs in a narrower call; ``paa`` within 1e-5 of the CPU
run, symbols and histograms equal on rows clear of breakpoints;
``lbs`` within rtol 1e-6, distances within rtol 1e-5 and positions equal
but between tied distances; the two-device mesh bitwise the host search;
on the second card, each kernel bitwise its run on the first and as near
its plain version as the kernel tests hold it (``sax_encode``,
``lb_paa_interval`` and ``dtw_band`` bitwise, ``pairwise_l2`` within
1e-5·(|q|² + |x|²), the LB kernels within rtol 1e-5)."""
import numpy as np
import pytest
import torch

from _torch_port import (assert_ties_only, clear_of_breakpoints, cuda,
                         torch_threads)  # noqa: F401
from repro_torch.core.build import DumpyParams
from repro_torch.core.distributed import (build_step, search_distributed,
                                          search_step)
from repro_torch.core.index import DumpyIndex
from repro_torch.core.sax import SaxParams, sax_encode_np
from repro_torch.core.search import exact_search
from repro_torch.core.search_device import exact_search_device_batch
from repro_torch.core.split import SplitParams
from repro_torch.data.series import random_walks
from repro_torch.distributed.sharding import make_mesh
from repro_torch.core.metric import Metric, query_prep
from repro_torch.kernels import (dtw_band, lb_improved, lb_isax, lb_keogh,
                                 ops, pairwise_l2, ref, sax_encode)

pytestmark = pytest.mark.cuda

PARAMS = DumpyParams(sax=SaxParams(w=16, b=8), split=SplitParams(th=2000))


def test_pairwise_l2_at_a_collection_wide_x(cuda):
    """``[64, 2 100 000, 256]``: 65 625 column tiles on ``grid.x`` and
    offsets past 2³¹ bytes; slices at the start, the middle and the ragged
    end against the twin and bitwise against a call over the slice alone."""
    g = torch.Generator(device=cuda).manual_seed(0)
    Q, X, n = 64, 2_100_000 + 7, 256
    q = torch.randn((Q, n), generator=g, device=cuda)
    x = torch.randn((X, n), generator=g, device=cuda)
    before = pairwise_l2.launches
    full = ops.pairwise_l2(q, x)
    assert pairwise_l2.launches == before + 1
    for s0 in (0, X // 2 + 3, X - 2000):
        xs = x[s0:s0 + 2000]
        part = full[:, s0:s0 + 2000]
        want = ref.pairwise_l2_ref(q, xs)
        scale = (q * q).sum(1)[:, None] + (xs * xs).sum(1)[None, :]
        assert bool(((part - want).abs() <= 1e-5 * scale).all())
        assert torch.equal(part, ops.pairwise_l2(q, xs))


def test_build_step_on_the_card_matches_its_cpu_run(cuda):
    db = random_walks(30_000, 256, seed=3)
    paa_h, _ = sax_encode_np(db, PARAMS.sax)
    db = db[clear_of_breakpoints(paa_h, 8).all(axis=1)]
    paa, sax, hist = build_step(torch.from_numpy(db).to(cuda), 16, 8)
    c_paa, c_sax, c_hist = build_step(torch.from_numpy(db), 16, 8)
    assert paa.is_cuda and sax.is_cuda and hist.is_cuda
    np.testing.assert_allclose(paa.cpu().numpy(), c_paa.numpy(), atol=1e-5)
    assert torch.equal(sax.cpu(), c_sax)
    assert torch.equal(hist.cpu(), c_hist)
    assert int(hist.sum()) == len(db)


def test_search_step_on_the_card_matches_its_cpu_run(cuda):
    db = random_walks(60_000, 256, seed=4)
    idx = DumpyIndex.build(db, PARAMS)
    qs = random_walks(64, 256, seed=5)
    t = torch.from_numpy
    args = (qs, idx.db_ordered, idx.flat.leaf_lo, idx.flat.leaf_hi)
    launches = (lb_isax.launches, pairwise_l2.launches)
    ids, d, lbs = search_step(*(t(a).to(cuda) for a in args), 10)
    assert (lb_isax.launches, pairwise_l2.launches) == (
        launches[0] + 1, launches[1] + 1)
    c_ids, c_d, c_lbs = search_step(*(t(a) for a in args), 10)
    np.testing.assert_allclose(lbs.cpu().numpy(), c_lbs.numpy(), rtol=1e-6)
    assert_ties_only(ids.cpu().numpy(), d.cpu().numpy(), c_ids.numpy(),
                     c_d.numpy())
    assert bool((lbs.sqrt() <= d[:, 0] * (1 + 1e-5)).all())


def test_two_device_mesh_exact_search_bitwise_host(cuda):
    """Shard 0 on the card, shard 1 on the CPU: each shard's program runs
    on its own device and the merged, re-ranked answers are bitwise the
    host ``exact_search``'s."""
    db = random_walks(40_000, 256, seed=6)
    idx = DumpyIndex.build(db, PARAMS)
    idx.delete(11)
    qs = random_walks(16, 256, seed=7)
    mesh = make_mesh([cuda, "cpu"])
    ids, d = search_distributed(idx, qs, 10, mesh=mesh)
    dev = idx.device_index(mesh=mesh)
    assert [t.device.type for t in dev.db] == ["cuda", "cpu"]
    assert dev.device.type == "cuda"
    assert dev.on(torch.device("cpu")).leaf_start.device.type == "cpu"
    one = exact_search_device_batch(idx, qs, 10, device=cuda)
    np.testing.assert_array_equal(ids, one[0])
    np.testing.assert_array_equal(d, one[1])
    for i, q in enumerate(qs):
        h_ids, h_d, _ = exact_search(idx, q, 10)
        np.testing.assert_array_equal(ids[i], h_ids)
        np.testing.assert_array_equal(d[i], h_d)
    ids_e, d_e = search_distributed(idx, qs, 10, nbr=4, mesh=mesh)
    one_e = search_distributed(idx, qs, 10, nbr=4, mesh=make_mesh([cuda]))
    np.testing.assert_array_equal(ids_e, one_e[0])
    np.testing.assert_array_equal(d_e, one_e[1])


two_cards = pytest.mark.skipif(
    not torch.cuda.is_available() or torch.cuda.device_count() < 2,
    reason="needs two CUDA cards")


def test_a_mesh_entry_on_an_absent_card_raises(cuda):
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="absent card"):
        make_mesh([f"cuda:{n}"])
    with pytest.raises(RuntimeError, match="absent card"):
        make_mesh(["cuda:0", f"cuda:{n + 3}"])


@two_cards
def test_two_card_mesh_search_bitwise_one_card():
    """Shards on ``cuda:0`` and ``cuda:1``: exact ED and DTW, extended ED
    with the re-rank and the degraded exact search bitwise the same mesh
    on ``cuda:0`` alone, each shard's tensors on its own card, also after
    a delete refreshes the placed tombstones (``with_alive``)."""
    db = random_walks(40_000, 256, seed=8)
    idx = DumpyIndex.build(db, PARAMS)
    qs = random_walks(16, 256, seed=9)
    two = make_mesh(["cuda:0", "cuda:1"])
    one = make_mesh(["cuda:0", "cuda:0"])
    for kw in ({}, {"metric": "dtw", "band": 25}, {"nbr": 4},
               {"shard_health": (False, True)}):
        got = search_distributed(idx, qs, 10, mesh=two, **kw)
        want = search_distributed(idx, qs, 10, mesh=one, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    dev = idx.device_index(mesh=two)
    assert [t.device for t in dev.db] == list(two.devices)
    assert [t.device for t in dev.alive] == list(two.devices)
    assert dev.on(torch.device("cuda:1")).leaf_start.device == \
        torch.device("cuda:1")
    assert dev.with_shard_health((True, False)).health_mask.device == \
        torch.device("cuda:0")
    victim = int(search_distributed(idx, qs, 10, mesh=two)[0][0, 0])
    idx.delete(victim)
    got = search_distributed(idx, qs, 10, mesh=two)
    assert victim not in got[0]
    for a, b in zip(got, search_distributed(idx, qs, 10, mesh=one)):
        np.testing.assert_array_equal(a, b)
    dev = idx.device_index(mesh=two)
    assert [t.device for t in dev.alive] == list(two.devices)


@two_cards
def test_every_kernel_on_the_second_card():
    """The six kernels on ``cuda:1``: each launches there, is bitwise the
    same call on ``cuda:0`` and agrees with its plain version."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn((64, 256), generator=g)
    x = torch.randn((2048, 256), generator=g).cumsum(1) / 16
    lo = torch.randn((300, 16), generator=g)
    hi = lo + torch.rand((300, 16), generator=g)
    met = Metric("dtw", 25)
    paa, _ = ops.sax_encode(q, 16, 8)
    seg_lo, seg_hi, env_lo, env_hi = query_prep(met, q, paa)
    idx = torch.randint(0, 2048, (16, 128), generator=g)
    mask = torch.rand((16, 128), generator=g) < 0.9
    cut = torch.full((16,), float("inf"))
    calls = (
        (sax_encode, lambda a: ops.sax_encode(a[0], 16, 8),
         lambda a: ref.sax_encode_in_order(a[0], 16, 8), (q,)),
        (pairwise_l2, lambda a: ops.pairwise_l2(*a),
         lambda a: ref.pairwise_l2_ref(*a), (q, x)),
        (lb_isax, lambda a: ops.lb_paa_interval(*a, 256),
         lambda a: ref.lb_paa_interval_in_order(*a, 256),
         (seg_lo, seg_hi, lo, hi)),
        (lb_keogh, lambda a: ops.lb_keogh(*a),
         lambda a: ref.lb_keogh_ref(*a), (x, env_hi, env_lo)),
        (lb_improved, lambda a: ops.lb_improved(*a, 25),
         lambda a: ref.lb_improved_ref(*a, 25), (x, q, env_hi, env_lo)),
        (dtw_band, lambda a: ops.dtw_band(*a[:4], 25, idx=a[4]),
         lambda a: ref.dtw_band_ref(*a[:4], 25, idx=a[4]),
         (q[:16], x, mask, cut, idx)))
    for mod, kern, plain, args in calls:
        name = mod.__name__.rsplit(".", 1)[-1]
        outs = []
        for card in ("cuda:0", "cuda:1"):
            a = tuple(t.to(card) for t in args)
            before = mod.launches
            got = kern(a)
            assert mod.launches == before + 1, (name, card)
            got = got if isinstance(got, tuple) else (got,)
            assert all(t.device == torch.device(card) for t in got)
            outs.append(tuple(t.cpu() for t in got))
        for u, v in zip(*outs):
            assert torch.equal(u, v), name
        want = plain(tuple(t.to("cuda:1") for t in args))
        want = tuple(t.cpu() for t in (want if isinstance(want, tuple)
                                       else (want,)))
        for got, w in zip(outs[1], want):
            if name in ("sax_encode", "lb_isax", "dtw_band"):
                assert torch.equal(got.to(w.dtype), w), name
            elif name == "pairwise_l2":
                scale = (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
                assert bool(((got - w).abs() <= 1e-5 * scale).all())
            else:
                fin = torch.isfinite(w)
                assert torch.equal(torch.isfinite(got), fin), name
                assert bool(((got - w).abs()
                             <= 1e-5 * w.abs() + 1e-6)[fin].all()), name
