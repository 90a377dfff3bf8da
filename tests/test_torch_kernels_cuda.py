"""The CUDA kernels against their plain PyTorch twins, on the card, over the
shape sweeps of ``test_kernels.py`` (and ``DTW_SWEEP`` for the DTW cascade,
``LBI_SWEEP`` for ``lb_improved``'s tiling, ``DTW_CUDA_EDGES`` for
``dtw_band``'s two paths and their edges, ``L2_CUDA_EDGES`` for
``pairwise_l2``'s copy instances, ragged tiles and long rows,
``LBK_CUDA_EDGES`` for ``lb_keogh``'s, ``SAX_CUDA_EDGES`` and
``LBPAA_CUDA_EDGES`` for ``sax_encode``'s and ``lb_paa_interval``'s, each
bitwise against its in-order loop):
the LB kernels within rtol 1e-5 — two sums of n nonnegative terms taken in
other orders — and ``dtw_band`` bitwise, ``+inf`` lanes included).  Imports no ``jax``, so it runs where
the card is (``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``);
everywhere else every case skips with a reason."""
import numpy as np
import pytest
import torch

from _torch_port import (DTW_CUDA_EDGES, DTW_SWEEP, L2_CUDA_EDGES,
                         L2_SWEEP, LB_SWEEP, LBK_CUDA_EDGES,
                         LBI_SWEEP, LBPAA_CUDA_EDGES, SAX_CUDA_EDGES,
                         SAX_SWEEP, clear_of_breakpoints, cuda,
                         dtw_inputs,
                         dtw_mask_cutoff, intervals,
                         torch_threads)  # noqa: F401
from repro_torch.kernels import (dtw_band, lb_improved, lb_isax, lb_keogh, ops,
                                 pairwise_l2, ref, sax_encode)

RNG = np.random.default_rng(43)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("B,n,w,b", SAX_SWEEP)
def test_sax_encode_kernel_matches_twin(cuda, B, n, w, b):
    x = torch.from_numpy(RNG.standard_normal((B, n)).astype(np.float32)).to(cuda)
    before = sax_encode.launches
    paa, sax = ops.sax_encode(x, w, b)
    assert sax_encode.launches == before + 1
    paa_r, sax_r = ref.sax_encode_ref(x, w, b)
    torch.testing.assert_close(paa, paa_r, rtol=1e-6, atol=1e-6)
    clear = torch.from_numpy(clear_of_breakpoints(paa_r.cpu().numpy(), b))
    assert torch.equal(sax.cpu()[clear], sax_r.cpu()[clear])


def _offset(t):
    """A copy of ``t`` one float into a buffer: its ``data_ptr`` is not
    16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = buf[1:].view(t.shape)
    v.copy_(t)
    assert v.data_ptr() % 16 != 0
    return v


def _rows(a, cuda, offset=False):
    """``a`` on the card; with ``offset`` an unaligned copy."""
    t = torch.from_numpy(a).to(cuda)
    return _offset(t) if offset else t


def _l2_close(q, x, got):
    """Within 1e-5·(|q_i|² + |x_j|²) of the twin: both round a sum of n
    products, each within n·2⁻²⁴ of its exact value in units of that
    scale (the twin's matmul in another order)."""
    want = ref.pairwise_l2_ref(q, x)
    scale = (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
    assert got.shape == want.shape and not torch.isnan(got).any()
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("Q,X,n", L2_SWEEP)
def test_pairwise_l2_kernel_matches_twin(cuda, Q, X, n):
    torch.backends.cuda.matmul.allow_tf32 = False
    q = torch.from_numpy(RNG.standard_normal((Q, n)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(RNG.standard_normal((X, n)).astype(np.float32)).to(cuda)
    _l2_close(q, x, ops.pairwise_l2(q, x))


@pytest.mark.parametrize("Q,X,n", L2_CUDA_EDGES)
@pytest.mark.parametrize("layout", ["aligned", "offset"])
def test_pairwise_l2_kernel_edges(cuda, Q, X, n, layout):
    """Ragged tiles, lengths not a multiple of 4, a long row, and operands
    whose ``data_ptr`` is not 16-byte aligned (the 4-byte copy instance)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q = _rows(RNG.standard_normal((Q, n)).astype(np.float32), cuda,
              layout == "offset")
    x = _rows(RNG.standard_normal((X, n)).astype(np.float32), cuda,
              layout == "offset")
    before = pairwise_l2.launches
    got = ops.pairwise_l2(q, x)
    assert pairwise_l2.launches == before + 1
    _l2_close(q, x, got)


@pytest.mark.parametrize("n", [97, 256])
def test_pairwise_l2_kernel_is_position_invariant_bitwise(cuda, n):
    """One (q_i, x_j) pair gives the same bits wherever its rows sit: other
    rows ahead of them (another tile position), another slab offset in a
    collection, an unaligned copy of the operands (the other copy
    instance at n = 256), and a second call."""
    Q, X = 20, 300
    db = torch.from_numpy(RNG.standard_normal((4096, n)).astype(np.float32)
                          ).to(cuda)
    q = torch.from_numpy(RNG.standard_normal((Q, n)).astype(np.float32)
                         ).to(cuda)
    base = ops.pairwise_l2(q, db[1000:1000 + X])
    assert torch.equal(ops.pairwise_l2(q, db[1000:1000 + X]), base)
    for lead_q, s0 in ((5, 963), (31, 999), (1, 0), (13, 1000 - 2047 % 300)):
        pad = torch.from_numpy(RNG.standard_normal((lead_q, n)).astype(
            np.float32)).to(cuda)
        q2 = torch.cat([pad, q, pad[:2]])
        got = ops.pairwise_l2(q2, db[s0:1000 + X + 7])
        c = 1000 - s0
        assert torch.equal(got[lead_q:lead_q + Q, c:c + X], base)
    got = ops.pairwise_l2(_rows(q.cpu().numpy(), cuda, True),
                          _rows(db[1000:1000 + X].cpu().numpy(), cuda, True))
    assert torch.equal(got, base)


@pytest.mark.parametrize("Q,L,w,n", LB_SWEEP)
def test_lb_paa_interval_kernel_matches_twin(cuda, Q, L, w, n):
    sl, sh, lo, hi = intervals(RNG, Q, L, w)
    lo[-1] = hi[-1] = np.inf                         # the +inf pad leaf
    t = [torch.from_numpy(a).to(cuda) for a in (sl, sh, lo, hi)]
    got = ops.lb_paa_interval(*t, n)
    want = ref.lb_paa_interval_ref(*t, n)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _sax_bitwise(x, w, b):
    """``sax_encode`` bitwise against ``ref.sax_encode_in_order``: PAA
    equal (NaN in the same places), every symbol equal to
    ``searchsorted(bp, paa, right=True)`` over the same float32 table.
    Returns the kernel's ``(paa, sax)``."""
    paa, sax = ops.sax_encode(x, w, b)
    want, sym = ref.sax_encode_in_order(x, w, b)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(paa), nan)
    assert torch.equal(paa[~nan], want[~nan])
    assert torch.equal(sax.long(), sym)
    return paa, sax


@pytest.mark.parametrize("B,n,w,b", SAX_CUDA_EDGES)
@pytest.mark.parametrize("align", ["aligned", "offset"])
def test_sax_encode_kernel_edges_bitwise(cuda, B, n, w, b, align):
    """Lengths and segments not a multiple of 4 and rows one float off
    16-byte alignment (the 4-byte copy instance), long segments, many
    tiles, no rows: bitwise against the in-order loop, every symbol."""
    x = _rows(RNG.standard_normal((B, n)).astype(np.float32), cuda,
              align == "offset" and B > 0)
    before = sax_encode.launches
    _sax_bitwise(x, w, b)
    assert sax_encode.launches == before + (B > 0)


@pytest.mark.parametrize("n,w", [(256, 16), (1023, 3), (96, 12)])
def test_sax_encode_kernel_is_position_invariant_bitwise(cuda, n, w):
    """The same rows give the same bits after other rows (another tile
    position and block), unaligned, and in a second call."""
    x = torch.from_numpy(RNG.standard_normal((700, n)).astype(np.float32)
                         ).to(cuda)
    base = ops.sax_encode(x, w, 8)
    for lead in (1, 37, 255, 513):
        pad = torch.from_numpy(RNG.standard_normal((lead, n)).astype(
            np.float32)).to(cuda)
        got = ops.sax_encode(torch.cat([pad, x, pad[:3]]), w, 8)
        for g, t in zip(got, base):
            assert torch.equal(g[lead:lead + 700], t)
    for args in ((x, w, 8), (_offset(x), w, 8)):
        for g, t in zip(ops.sax_encode(*args), base):
            assert torch.equal(g, t)


def test_sax_encode_kernel_nan_rows(cuda):
    """A NaN in a row makes its segment's mean NaN, as the in-order sum
    does, and its symbol the one searchsorted gives a NaN."""
    x = RNG.standard_normal((9, 256)).astype(np.float32)
    x[2, 17] = x[5, 0] = x[5, 255] = np.nan
    for xx in (x, x[:, :255].copy()):
        paa, _ = _sax_bitwise(torch.from_numpy(xx).to(cuda),
                              16 if xx.shape[1] == 256 else 5, 8)
        assert int(torch.isnan(paa).sum()) == (3 if xx.shape[1] == 256
                                               else 2)


@pytest.mark.parametrize("Q,L,w", LBPAA_CUDA_EDGES)
@pytest.mark.parametrize("align", ["aligned", "offset"])
def test_lb_paa_interval_kernel_edges_bitwise(cuda, Q, L, w, align):
    """The generic instance's widths up to 64, the compiled ones, ragged
    tiles, a 100 M-series table, operands one float off 16-byte alignment
    (scalar loads), empty Q or L: bitwise against the in-order loop, the
    +inf pad leaf +inf, within 1e-6 of the twin."""
    sl, sh, lo, hi = intervals(RNG, Q, L, w)
    if L:
        lo[-1] = hi[-1] = np.inf
    off = align == "offset" and Q > 0 and L > 0
    t = [_rows(a, cuda, off) for a in (sl, sh, lo, hi)]
    n = 4 * w + 1
    before = lb_isax.launches
    got = ops.lb_paa_interval(*t, n)
    assert lb_isax.launches == before + (Q > 0 and L > 0)
    assert got.shape == (Q, L) and not torch.isnan(got).any()
    assert torch.equal(got, ref.lb_paa_interval_in_order(*t, n))
    if L:
        assert torch.isinf(got[:, -1]).all()
    torch.testing.assert_close(got, ref.lb_paa_interval_ref(*t, n),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("w", [8, 16, 33, 64])
def test_lb_paa_interval_kernel_is_position_invariant_bitwise(cuda, w):
    """One (query, leaf) pair gives the same bits wherever its rows sit:
    other queries and leaves ahead of and behind them (other query groups,
    leaf tiles and launch shapes), unaligned copies, and a second call."""
    sl, sh, lo, hi = (torch.from_numpy(a).to(cuda)
                      for a in intervals(RNG, 20, 300, w))
    base = ops.lb_paa_interval(sl, sh, lo, hi, 256)
    assert torch.equal(ops.lb_paa_interval(sl, sh, lo, hi, 256), base)
    for lead_q, lead_l, reps in ((3, 37, 1), (31, 129, 1), (1, 5, 60)):
        pq = [torch.from_numpy(a).to(cuda) for a in intervals(
            RNG, lead_q + 2, lead_l + 7, w)]
        cat = torch.cat
        got = ops.lb_paa_interval(
            cat([pq[0][:lead_q], sl, pq[0][lead_q:]] * reps),
            cat([pq[1][:lead_q], sh, pq[1][lead_q:]] * reps),
            cat([pq[2][:lead_l], lo, pq[2][lead_l:]]),
            cat([pq[3][:lead_l], hi, pq[3][lead_l:]]), 256)
        assert torch.equal(got[lead_q:lead_q + 20, lead_l:lead_l + 300],
                           base)
    got = ops.lb_paa_interval(*(_offset(t) for t in (sl, sh, lo, hi)), 256)
    assert torch.equal(got, base)


def _lb_close(got, want):
    """Both are sums of n nonnegative float32 terms in different orders:
    each is within (n-1)·2⁻²⁴ of the exact sum, so rtol 1e-5 covers
    n ≤ 256 with room."""
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Q,m,n,r", DTW_SWEEP)
@pytest.mark.parametrize("layout", ["shared", "gather"])
def test_lb_keogh_kernel_matches_twin(cuda, Q, m, n, r, layout):
    qs, xs, cand, U, L = dtw_inputs(RNG, Q, m, n, r)
    x = torch.from_numpy(xs if layout == "shared" else cand).to(cuda)
    U, L = (torch.from_numpy(a).to(cuda) for a in (U, L))
    before = lb_keogh.launches
    got = ops.lb_keogh(x, U, L)
    assert lb_keogh.launches == before + 1
    _lb_close(got, ref.lb_keogh_ref(x, U, L))


def _walks(gen, *shape):
    """Random walks along the last axis, made on the card."""
    return torch.randn(*shape, generator=gen, device="cuda").cumsum(-1)


def _envelopes(qs):
    """The envelopes ``(U, L)`` of ``qs`` at band n // 10 from the twin,
    their first and last column infinite."""
    from repro_torch.core.lb import dtw_envelope_batch
    U, L = (t.clone() for t in dtw_envelope_batch(
        qs, max(qs.shape[1] // 10, 1)))
    U[:, [0, -1]] = float("inf")
    L[:, [0, -1]] = -float("inf")
    return U, L


@pytest.mark.parametrize("Q,m,n", LBK_CUDA_EDGES)
@pytest.mark.parametrize("layout", ["shared", "gather"])
@pytest.mark.parametrize("align", ["aligned", "offset"])
def test_lb_keogh_kernel_edges(cuda, Q, m, n, layout, align):
    """Ragged tiles, lengths not a multiple of 4, long rows (one past what
    the first kernel could stage), and operands whose ``data_ptr`` is not
    16-byte aligned (the 4-byte copy instance), in both layouts."""
    gen = torch.Generator(device="cuda").manual_seed(Q * 7919 + m * 31 + n)
    U, L = _envelopes(_walks(gen, Q, n))
    x = _walks(gen, *((m, n) if layout == "shared" else (Q, m, n)))
    if align == "offset":
        x, U, L = _offset(x), _offset(U), _offset(L)
    before = lb_keogh.launches
    got = ops.lb_keogh(x, U, L)
    assert lb_keogh.launches == before + 1
    _lb_close(got, ref.lb_keogh_ref(x, U, L))


@pytest.mark.parametrize("n", [97, 256])
def test_lb_keogh_kernel_is_position_invariant_bitwise(cuda, n):
    """One (row, query) pair gives the same bits wherever it sits: other
    queries ahead of it (another tile position), another slab offset in a
    collection, unaligned copies of the operands (the other copy instance
    at n = 256), the per-query layout over a gather of the rows, and a
    second call."""
    gen = torch.Generator(device="cuda").manual_seed(n)
    Q, m = 20, 300
    db = _walks(gen, 4096, n)
    U, L = _envelopes(_walks(gen, Q + 40, n))
    Ua, Ub, La, Lb = U[:Q], U[Q:], L[:Q], L[Q:]
    base = ops.lb_keogh(db[1000:1000 + m], Ua, La)
    assert torch.equal(ops.lb_keogh(db[1000:1000 + m], Ua, La), base)
    for lead_q, s0 in ((5, 963), (31, 999), (1, 0), (13, 1000 - 2047 % 300)):
        U2 = torch.cat([Ub[:lead_q], Ua, Ub[lead_q:lead_q + 2]])
        L2 = torch.cat([Lb[:lead_q], La, Lb[lead_q:lead_q + 2]])
        got = ops.lb_keogh(db[s0:1000 + m + 7], U2, L2)
        c = 1000 - s0
        assert torch.equal(got[lead_q:lead_q + Q, c:c + m], base)
    got = ops.lb_keogh(_offset(db[1000:1000 + m]), _offset(Ua), _offset(La))
    assert torch.equal(got, base)
    idx = torch.randint(0, m, (Q, 77), generator=gen, device="cuda")
    rows = db[1000:1000 + m][idx].contiguous()
    want = torch.gather(base, 1, idx)
    assert torch.equal(ops.lb_keogh(rows, Ua, La), want)
    assert torch.equal(ops.lb_keogh(_offset(rows), _offset(Ua),
                                    _offset(La)), want)


def test_lb_keogh_kernel_empty_rows(cuda):
    """n = 0 gives zeros (the sum of no terms); Q = 0 or m = 0 an empty
    result."""
    z = torch.empty
    got = ops.lb_keogh(z((5, 0), device="cuda"), z((3, 0), device="cuda"),
                       z((3, 0), device="cuda"))
    assert torch.equal(got, torch.zeros((3, 5), device="cuda"))
    assert ops.lb_keogh(z((0, 8), device="cuda"), z((3, 8), device="cuda"),
                        z((3, 8), device="cuda")).shape == (3, 0)
    assert ops.lb_keogh(z((5, 8), device="cuda"), z((0, 8), device="cuda"),
                        z((0, 8), device="cuda")).shape == (0, 5)


@pytest.mark.parametrize("Q,m,n,r", LBI_SWEEP)
@pytest.mark.parametrize("layout", ["shared", "gather"])
def test_lb_improved_kernel_matches_twin(cuda, Q, m, n, r, layout):
    qs, xs, cand, U, L = dtw_inputs(RNG, Q, m, n, r)
    x = torch.from_numpy(xs if layout == "shared" else cand).to(cuda)
    q, U, L = (torch.from_numpy(a).to(cuda) for a in (qs, U, L))
    before = lb_improved.launches
    got = ops.lb_improved(x, q, U, L, r)
    assert lb_improved.launches == before + 1
    _lb_close(got, ref.lb_improved_ref(x, q, U, L, r))


def _dtw_band_case(cuda, Q, m, n, r, layout, on=0.7, rows=None):
    qs, xs, cand, _, _ = dtw_inputs(RNG, Q, m, n, r)
    mask, cut = dtw_mask_cutoff(RNG, qs, xs if layout != "gather" else cand,
                                r, on)
    t = {a: torch.from_numpy(v).to(cuda) for a, v in
         dict(qs=qs, xs=xs, cand=cand, mask=mask, cut=cut).items()}
    idx = None
    x = t["cand"] if layout == "gather" else t["xs"]
    if layout == "rows":   # the given rows, or each query's lanes reversed
        idx = (torch.arange(m - 1, -1, -1, device=cuda).repeat(Q, 1)
               if rows is None else torch.from_numpy(rows).to(cuda))
    before = dtw_band.launches
    got = ops.dtw_band(t["qs"], x, t["mask"], t["cut"], r, idx=idx)
    assert dtw_band.launches == before + 1
    want = ref.dtw_band_ref(t["qs"], x, t["mask"], t["cut"], r, idx=idx)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(got, want)
    assert torch.isinf(got[~t["mask"]]).all()


@pytest.mark.parametrize("Q,m,n,r", DTW_SWEEP)
@pytest.mark.parametrize("layout", ["shared", "gather", "rows"])
def test_dtw_band_kernel_matches_twin_bitwise(cuda, Q, m, n, r, layout):
    _dtw_band_case(cuda, Q, m, n, r, layout)


@pytest.mark.parametrize("Q,m,n,r,on", DTW_CUDA_EDGES)
@pytest.mark.parametrize("layout", ["shared", "gather", "rows"])
def test_dtw_band_kernel_edges_bitwise(cuda, Q, m, n, r, on, layout):
    """Both paths at their split, a lane-walk call whose rows repeat, a
    band past the old cap, and an all-masked call."""
    _dtw_band_case(cuda, Q, m, n, r, layout, on,
                   rows=RNG.integers(0, m, (Q, m)))


@pytest.mark.parametrize("X,n,k", [(100, 64, 3), (2048, 256, 10),
                                   (5, 97, 9)])
def test_knn_from_leaves_on_card(cuda, X, n, k):
    """``ops.knn_from_leaves`` on CUDA launches ``pairwise_l2`` once; its
    distances within 1e-5 (|q|^2 + |x|^2) of the twin's, ids equal except
    between such ties, an exact tie (a repeated row) in position order."""
    x = RNG.standard_normal((X, n)).astype(np.float32)
    x[X // 2] = x[X // 3]
    xt = torch.from_numpy(x).to(cuda)
    q = xt[X // 3]
    before = pairwise_l2.launches
    ids, d2 = ops.knn_from_leaves(q, xt, k)
    assert pairwise_l2.launches == before + 1
    want = ref.pairwise_l2_ref(q[None], xt)[0]
    w_d2, w_ids = torch.sort(want, stable=True)
    scale = float((q * q).sum()) + (xt * xt).sum(1)
    assert ids.shape == d2.shape == (min(k, X),)
    assert bool(((d2 - w_d2[:k]).abs() <= 1e-5 * scale[w_ids[:k]]).all())
    tie = 1e-5 * float(scale.max())
    for j in torch.nonzero(ids != w_ids[:k]).flatten().tolist():
        assert abs(float(w_d2[j]) - float(w_d2[j - 1 if j else 1])) <= tie
    assert sorted(ids[:2].tolist()) == ids[:2].tolist() == \
        sorted({X // 3, X // 2})
