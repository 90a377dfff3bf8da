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
    """ED prep stays the degenerate interval; DTW prep, which an earlier
    slice refused, equals ``query_prep_jnp`` exactly (envelopes and their
    segment summary are max/min, no rounding)."""
    qs = torch.from_numpy(RNG.standard_normal((3, 64)).astype(np.float32))
    paa = sax.paa_t(qs, 8)
    seg_lo, seg_hi, env_lo, env_hi = metric.query_prep(metric.ED, qs, paa)
    assert seg_lo is paa and seg_hi is paa and env_lo is qs and env_hi is qs
    for band in (1, 6, 63, 70):
        met = metric.resolve("dtw", 64, band)
        got = metric.query_prep(met, qs, paa)
        want = r_metric.query_prep_jnp(
            r_metric.resolve("dtw", 64, band), jnp.asarray(qs.numpy()),
            jnp.asarray(paa.numpy()))
        for g, w in zip(got, want):
            _same(g.numpy(), np.asarray(w))


def _walks(*shape):
    return np.cumsum(RNG.standard_normal(shape), axis=-1).astype(np.float32)


def test_dtw_host_copies_bitwise():
    n, w, r = 64, 8, 6
    q, x = _walks(n), _walks(n)
    _same(lb.dtw_np(q, x, r), r_lb.dtw_np(q, x, r))
    U, L = lb.dtw_envelope_np(q, r)
    for g, want in zip((U, L), r_lb.dtw_envelope_np(q, r)):
        _same(g, want)
    for g, want in zip(lb.envelope_paa_np(U, L, w),
                       r_lb.envelope_paa_np(U, L, w)):
        _same(g, want)
    xs = _walks(30, n)
    _same(lb.lb_keogh_np(xs, U, L), r_lb.lb_keogh_np(xs, U, L))
    Us, Ls = lb.envelope_paa_np(U, L, w)
    lo = RNG.standard_normal((30, w)).astype(np.float32)
    hi = lo + np.abs(RNG.standard_normal((30, w))).astype(np.float32)
    _same(lb.mindist_dtw_bounds_np(Us, Ls, lo, hi, n),
          r_lb.mindist_dtw_bounds_np(Us, Ls, lo, hi, n))
    paa = sax.paa_np(q, w)
    met, r_met = metric.resolve("dtw", n, r), r_metric.resolve("dtw", n, r)
    for g, want in zip(metric.query_prep_np(met, q, paa),
                       r_metric.query_prep_np(r_met, q, paa)):
        _same(g, want)
    # the interval MINDIST over the envelope summary is the DTW bound
    _same(metric.interval_mindist_np(Ls, Us, lo, hi, n),
          lb.mindist_dtw_bounds_np(Us, Ls, lo, hi, n))


@pytest.mark.parametrize("Q,kk,n,r", [(5, 7, 48, 5), (2, 3, 17, 20)])
def test_dtw_np_batch_bitwise(Q, kk, n, r):
    qs, cand = _walks(Q, n), _walks(Q, kk, n)
    got = lb.dtw_np_batch(qs, cand, r)
    _same(got, r_lb.dtw_np_batch(qs, cand, r))
    # the scalar DP agrees to float32 (numpy squares an f32 scalar through
    # powf and an f32 array by multiplying, so the f64 sums may differ in
    # their last bit; the search's re-rank returns float32)
    _same(np.float32(got[1, 2]), np.float32(lb.dtw_np(qs[1], cand[1, 2], r)))


@pytest.mark.parametrize("n", [7, 17, 64])
@pytest.mark.parametrize("r", [0, 1, 3, 6, 70])
def test_window_minmax_and_envelope_exact(n, r):
    x = RNG.standard_normal((4, n)).astype(np.float32)
    t = torch.from_numpy(x)
    _same(lb._window_max(t, r).numpy(),
          np.asarray(r_lb._window_max(jnp.asarray(x), r)))
    _same(lb._window_min(t, r).numpy(),
          np.asarray(r_lb._window_min(jnp.asarray(x), r)))
    for g, want in zip(lb.dtw_envelope_batch(t, r),
                       r_lb.dtw_envelope_batch_jnp(jnp.asarray(x), r)):
        _same(g.numpy(), np.asarray(want))


@pytest.mark.parametrize("Q,m,n,r", [(1, 1, 64, 6), (6, 40, 64, 6),
                                     (4, 30, 256, 25), (3, 20, 17, 20)])
@pytest.mark.parametrize("layout", ["shared", "gather"])
def test_lb_cascade_matches_jnp(Q, m, n, r, layout):
    """Sums over n in another order than XLA's: rtol 1e-6."""
    qs = _walks(Q, n)
    xs = _walks(m, n) if layout == "shared" else _walks(Q, m, n)
    U, L = r_lb.dtw_envelope_batch_jnp(jnp.asarray(qs), r)
    Ut, Lt = (torch.from_numpy(np.array(a)) for a in (U, L))
    want = np.asarray(r_lb.lb_keogh2_batch_jnp(jnp.asarray(xs), U, L))
    got = lb.lb_keogh2_batch(torch.from_numpy(xs), Ut, Lt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want = np.asarray(r_lb.lb_improved2_batch_jnp(
        jnp.asarray(xs), jnp.asarray(qs), U, L, r))
    got = lb.lb_improved2_batch(torch.from_numpy(xs), torch.from_numpy(qs),
                                Ut, Lt, r).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got >= lb.lb_keogh2_batch(torch.from_numpy(xs), Ut, Lt).numpy()
            * (1 - 1e-6)).all()


@pytest.mark.parametrize("Q,m,n,r", [(1, 1, 64, 6), (6, 40, 64, 6),
                                     (4, 30, 256, 25), (3, 20, 17, 20),
                                     (2, 9, 32, 31)])
@pytest.mark.parametrize("layout", ["shared", "gather"])
def test_dtw2_masked_bitwise_jnp(Q, m, n, r, layout):
    """The anti-diagonal DP, random masks and finite cutoffs: bitwise,
    ``+inf`` lanes included (``r + 1 >= n`` takes the full-width form)."""
    qs = _walks(Q, n)
    xs = _walks(m, n) if layout == "shared" else _walks(Q, m, n)
    mask = RNG.random((Q, m)) < 0.7
    r_fn = (r_lb.dtw2_masked_batch_jnp if layout == "shared"
            else r_lb.dtw2_masked_gather_jnp)
    fn = lb.dtw2_masked_batch if layout == "shared" else lb.dtw2_masked_gather
    full = np.asarray(r_fn(jnp.asarray(qs), jnp.asarray(xs), r,
                           jnp.ones((Q, m), bool),
                           jnp.full((Q,), np.inf, jnp.float32)))
    cut = np.quantile(full, 0.4, axis=1).astype(np.float32)
    want = np.asarray(r_fn(jnp.asarray(qs), jnp.asarray(xs), r,
                           jnp.asarray(mask), jnp.asarray(cut)))
    got = fn(torch.from_numpy(qs), torch.from_numpy(xs), r,
             torch.from_numpy(mask), torch.from_numpy(cut)).numpy()
    _same(got, want)
    assert np.isinf(got[~mask]).all()
    if m > 1:
        assert np.isfinite(got).any() and np.isinf(got[mask]).any()
