"""The port's numerics against the reference: the numpy copies in
``core.sax`` / ``core.lb`` / ``core.metric`` bitwise, the torch halves
allclose to their jnp counterparts."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_port import torch_threads  # noqa: F401
from repro.core import lb as r_lb
from repro.core import metric as r_metric
from repro.core import sax as r_sax
from repro_torch.core import lb, metric, sax

RNG = np.random.default_rng(7)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("b", [1, 2, 4, 8, 10])
def test_breakpoint_tables_bitwise(b):
    _same(sax.breakpoints(b), r_sax.breakpoints(b))
    _same(sax.breakpoints_ext(b), r_sax.breakpoints_ext(b))
    _same(sax.region_midpoints(b), r_sax.region_midpoints(b))


@pytest.mark.parametrize("n,w,b", [(64, 8, 8), (256, 16, 8), (96, 12, 4)])
def test_sax_numpy_encoders_bitwise(n, w, b):
    x = RNG.standard_normal((50, n)).astype(np.float32)
    _same(sax.paa_np(x, w), r_sax.paa_np(x, w))
    p = sax.paa_np(x.astype(np.float64), w)
    _same(sax.sax_from_paa_np(p, b), r_sax.sax_from_paa_np(p, b))
    for got, want in zip(sax.sax_encode_np(x, sax.SaxParams(w=w, b=b)),
                         r_sax.sax_encode_np(x, r_sax.SaxParams(w=w, b=b))):
        _same(got, want)


def test_isax_bit_helpers_bitwise():
    b, w = 8, 8
    s = RNG.integers(0, 256, (40, w)).astype(np.uint8)
    card = RNG.integers(0, b + 1, w)
    _same(sax.prefix_np(s, card, b), r_sax.prefix_np(s, card, b))
    _same(sax.next_bits_np(s, card, b), r_sax.next_bits_np(s, card, b))
    bits = sax.next_bits_np(s, card, b)
    _same(sax.pack_bits_np(bits), r_sax.pack_bits_np(bits))
    codes = sax.pack_bits_np(bits)
    _same(sax.extract_bits_np(codes, [0, 3, 5], w),
          r_sax.extract_bits_np(codes, [0, 3, 5], w))
    sym = sax.prefix_np(s, card, b)
    for got, want in zip(sax.isax_bounds_np(sym, card, b),
                         r_sax.isax_bounds_np(sym, card, b)):
        _same(got, want)
    for got, want in zip(lb.node_bounds_np(sym, card, b),
                         r_lb.node_bounds_np(sym, card, b)):
        _same(got, want)


def test_sax_params_validation():
    assert sax.SaxParams().c == r_sax.SaxParams().c == 256
    with pytest.raises(ValueError, match="divisible by w=16"):
        sax.SaxParams().validate_series_length(100)


def test_ed_and_mindist_numpy_bitwise():
    n, w = 64, 8
    q = RNG.standard_normal(n).astype(np.float32)
    xs = RNG.standard_normal((30, n)).astype(np.float32)
    _same(lb.ed_np(q, xs), r_lb.ed_np(q, xs))
    paa = sax.paa_np(q, w)
    lo = RNG.standard_normal((30, w)).astype(np.float32)
    hi = lo + np.abs(RNG.standard_normal((30, w))).astype(np.float32)
    _same(lb.mindist_paa_bounds_np(paa, lo, hi, n),
          r_lb.mindist_paa_bounds_np(paa, lo, hi, n))
    sl = paa - 0.1
    sh = paa + 0.1
    _same(metric.interval_mindist_np(sl, sh, lo, hi, n),
          r_metric.interval_mindist_np(sl, sh, lo, hi, n))
    _same(metric.interval_mindist_np(paa, paa, lo, hi, n),
          lb.mindist_paa_bounds_np(paa, lo, hi, n))


@pytest.mark.parametrize("B,n,w,b", [(33, 64, 8, 8), (7, 256, 16, 8),
                                     (100, 96, 12, 4)])
def test_sax_encode_t_matches_jnp(B, n, w, b):
    x = RNG.standard_normal((B, n)).astype(np.float32)
    paa_r, sax_r = (np.asarray(a) for a in r_sax.sax_encode_jnp(
        jnp.asarray(x), w, b))
    paa, s = sax.sax_encode_t(torch.from_numpy(x), w, b)
    assert s.dtype == torch.uint8 and sax_r.dtype == np.uint8
    np.testing.assert_allclose(paa.numpy(), paa_r, rtol=1e-6, atol=1e-6)
    clear = np.abs(paa_r[..., None] - sax.breakpoints(b)).min(-1) > 1e-5
    np.testing.assert_array_equal(s.numpy()[clear], sax_r[clear])


@pytest.mark.parametrize("Q,m,n", [(1, 1, 64), (9, 70, 64), (64, 300, 256)])
def test_ed2_batch_matches_jnp(Q, m, n):
    q = RNG.standard_normal((Q, n)).astype(np.float32)
    xs = RNG.standard_normal((m, n)).astype(np.float32)
    want = np.asarray(r_lb.ed2_batch_jnp(jnp.asarray(q), jnp.asarray(xs)))
    got = lb.ed2_batch(torch.from_numpy(q), torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("Q,L,w,n", [(1, 1, 8, 64), (9, 77, 16, 128),
                                     (64, 400, 16, 256)])
def test_lb_interval_matches_jnp(Q, L, w, n):
    lo = RNG.standard_normal((L, w)).astype(np.float32)
    hi = lo + np.abs(RNG.standard_normal((L, w))).astype(np.float32)
    sl = RNG.standard_normal((Q, w)).astype(np.float32)
    sh = sl + np.abs(RNG.standard_normal((Q, w))).astype(np.float32)
    want = np.asarray(r_lb.lb_interval_jnp(*(jnp.asarray(a)
                                             for a in (sl, sh, lo, hi)), n))
    got = lb.lb_interval(*(torch.from_numpy(a) for a in (sl, sh, lo, hi)),
                         n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_metric_resolution_matches_reference():
    for args in [("ed", 64), ("dtw", 64), ("dtw", 256, 7), ("ed", 64, None,
                                                             "perq")]:
        got, want = metric.resolve(*args), r_metric.resolve(*args)
        assert (got.name, got.band, got.order) == \
            (want.name, want.band, want.order)
    for n in (8, 64, 100, 256):
        assert metric.default_band(n) == r_metric.default_band(n)
    assert metric.ORDERS == r_metric.ORDERS
    assert metric.ED == metric.Metric("ed", 0)
    with pytest.raises(ValueError, match="unknown metric"):
        metric.Metric("l1")
    with pytest.raises(ValueError, match="unknown order"):
        metric.Metric("dtw", 3, "best")


def test_query_prep_ed_is_degenerate_and_dtw_waits():
    qs = torch.from_numpy(RNG.standard_normal((3, 64)).astype(np.float32))
    paa = sax.paa_t(qs, 8)
    seg_lo, seg_hi, env_lo, env_hi = metric.query_prep(metric.ED, qs, paa)
    assert seg_lo is paa and seg_hi is paa and env_lo is qs and env_hi is qs
    with pytest.raises(NotImplementedError, match="DTW slice"):
        metric.query_prep(metric.resolve("dtw", 64), qs, paa)
