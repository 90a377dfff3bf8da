"""The port's kernel twins against the reference's Pallas kernels (run in
interpret mode, as ``test_kernels.py`` runs them) over the same shape
sweeps (the DTW cascade: LB twins within rtol 1e-6, the DP bitwise).  The CUDA kernels against their twins, on the card, are in
``test_torch_kernels_cuda.py``."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_port import (DTW_SWEEP, L2_SWEEP, LB_SWEEP, SAX_SWEEP,
                         clear_of_breakpoints,
                         dtw_inputs, dtw_mask_cutoff, intervals,
                         torch_threads)  # noqa: F401
from repro.kernels import ops as r_ops
from repro.kernels.dtw_band import dtw_band as r_dtw_band
from repro.kernels.lb_isax import lb_isax as r_lb_isax
from repro.kernels.lb_isax import lb_paa_interval as r_lb_paa_interval
from repro.kernels.lb_keogh import lb_improved as r_lb_improved
from repro.kernels.lb_keogh import lb_keogh as r_lb_keogh
from repro.kernels.pairwise_l2 import pairwise_l2 as r_pairwise_l2
from repro.kernels.sax_encode import sax_encode as r_sax_encode
from repro_torch.core.sax import breakpoints
from repro_torch.kernels import (dtw_band, lb_improved, lb_isax, lb_keogh, ops,
                                 pairwise_l2, ref, sax_encode)

RNG = np.random.default_rng(42)


@pytest.mark.parametrize("B,n,w,b", SAX_SWEEP)
def test_sax_encode_twin_matches_pallas(B, n, w, b):
    x = RNG.standard_normal((B, n)).astype(np.float32)
    paa_r, sax_r = r_sax_encode(jnp.asarray(x), w=w, b=b, interpret=True)
    paa, sax = ops.sax_encode(torch.from_numpy(x), w, b)
    assert paa.dtype == torch.float32 and sax.dtype == torch.int32
    paa_r, sax_r = np.asarray(paa_r), np.asarray(sax_r)
    np.testing.assert_allclose(paa.numpy(), paa_r, rtol=1e-5, atol=1e-5)
    clear = clear_of_breakpoints(paa_r, b)
    np.testing.assert_array_equal(sax.numpy()[clear], sax_r[clear])


@pytest.mark.parametrize("Q,X,n", L2_SWEEP)
def test_pairwise_l2_twin_matches_pallas(Q, X, n):
    q = RNG.standard_normal((Q, n)).astype(np.float32)
    x = RNG.standard_normal((X, n)).astype(np.float32)
    want = np.asarray(r_pairwise_l2(jnp.asarray(q), jnp.asarray(x),
                                    interpret=True))
    got = ops.pairwise_l2(torch.from_numpy(q), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-4)


def _fma32(a, b, c):
    """One float32 FMA, modelled as ``fl32(fl64(a)·fl64(b) + fl64(c))`` (the
    product of two float32 is exact in float64)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


# pairwise_l2.cu's tiling: 32x32 tiles of 256 threads, 32-column chunks in a
# ring of 8, column classes (c // 4) % 4 summed by two warps each, 4x4
# register tiles, padded strides of the staged rows and the partial tiles
L2_TQ, L2_TX, L2_KC, L2_LDK, L2_NS, L2_CLASSES, L2_PLD = 32, 32, 32, 36, 8, 4, 40


def _l2_tile_model(q: np.ndarray, x: np.ndarray, vec: bool) -> np.ndarray:
    """A numpy walk of ``pairwise_l2.cu``, block by block, its 256 threads
    side by side: the copy map of either instance (16-byte copies by 16
    threads a row, or 4-byte copies by 64) into the ring slot of each
    chunk (zero-filled past Q, X and n; a never-copied element stays NaN),
    each warp's column class, register rows and norm row, one FMA a column,
    the partial tiles and norms added in class order through the padded
    epilogue buffers (each written once), and the store map (each output
    written once)."""
    Q, n = q.shape
    X = x.shape[0]
    assert not vec or n % 4 == 0          # the launcher's choice
    rows = L2_TQ + L2_TX
    tid = np.arange(256)
    warp, lane = tid >> 5, tid & 31
    cls, w = warp >> 1, warp & 1
    tq, tx = lane >> 3, lane & 7
    qrow = 16 * w[:, None] + tq[:, None] + 4 * np.arange(4)    # [256, i]
    xrow = L2_TQ + tx[:, None] + 8 * np.arange(4)              # [256, j]
    nrow = 32 * w + lane
    chunks = -(-n // L2_KC)
    out = np.full((Q, X), np.nan, np.float32)
    stored = np.zeros((Q, X), int)
    for q0 in range(0, Q, L2_TQ):
        for x0 in range(0, X, L2_TX):
            ring = np.full((L2_NS, rows, L2_LDK), np.nan, np.float32)
            holds = [-1] * L2_NS

            def load(c):
                slot, k0 = ring[c % L2_NS], c * L2_KC
                holds[c % L2_NS] = c
                slot[:, :L2_KC] = np.nan
                per_row, width = (L2_KC // 4, 4) if vec else (L2_KC, 1)
                for k in range(rows * per_row // 256):
                    idx = tid + 256 * k
                    r, col = idx // per_row, (idx % per_row) * width
                    isq = r < L2_TQ
                    gr = np.where(isq, q0 + r, x0 + r - L2_TQ)
                    # a copy tests its row and its first column
                    inq = isq & (gr < Q) & (k0 + col < n)
                    inx = ~isq & (gr < X) & (k0 + col < n)
                    for e in range(width):
                        val = np.zeros(256, np.float32)
                        val[inq] = q[gr[inq], k0 + col[inq] + e]
                        val[inx] = x[gr[inx], k0 + col[inx] + e]
                        assert np.isnan(slot[r, col + e]).all()  # once each
                        slot[r, col + e] = val

            for c in range(min(L2_NS - 1, chunks)):
                load(c)
            acc = np.zeros((256, 4, 4), np.float32)
            norm = np.zeros(256, np.float32)
            for c in range(chunks):
                if c + L2_NS - 1 < chunks:
                    load(c + L2_NS - 1)
                assert holds[c % L2_NS] == c
                st = ring[c % L2_NS]
                for g in range(L2_KC // 4 // L2_CLASSES):
                    col = 4 * (cls + L2_CLASSES * g)                # [256]
                    for e in range(4):
                        a = st[qrow, (col + e)[:, None]]            # [256, i]
                        b = st[xrow, (col + e)[:, None]]            # [256, j]
                        acc = _fma32(a[:, :, None], b[:, None, :], acc)
                        v = st[nrow, col + e]
                        norm = _fma32(v, v, norm)
            part = np.full((L2_CLASSES, L2_TQ, L2_PLD), np.nan, np.float32)
            norms = np.full((L2_CLASSES, rows), np.nan, np.float32)
            hit = np.zeros(part.shape, int)
            for i in range(4):
                for j in range(4):
                    part[cls, qrow[:, i], xrow[:, j] - L2_TQ] = acc[:, i, j]
                    hit[cls, qrow[:, i], xrow[:, j] - L2_TQ] += 1
            norms[cls, nrow] = norm
            assert (hit[:, :, :L2_TX] == 1).all()
            assert not np.isnan(norms).any()
            for k in range(L2_TQ // 8):
                r, cc = warp + 8 * k, lane
                gr, gc = q0 + r, x0 + cc
                dot, qn, xn = part[0, r, cc], norms[0, r], norms[0, L2_TQ + cc]
                for s in range(1, L2_CLASSES):
                    dot = (dot + part[s, r, cc]).astype(np.float32)
                    qn = (qn + norms[s, r]).astype(np.float32)
                    xn = (xn + norms[s, L2_TQ + cc]).astype(np.float32)
                d = ((qn + xn).astype(np.float32)
                     - (np.float32(2) * dot).astype(np.float32))
                keep = (gr < Q) & (gc < X)
                out[gr[keep], gc[keep]] = np.maximum(d.astype(np.float32),
                                                     0)[keep]
                stored[gr[keep], gc[keep]] += 1
    assert (stored == 1).all()
    return out


def _l2_pair_value(q: np.ndarray, x: np.ndarray) -> np.ndarray:
    """What the kernel must give as a function of ``(q_i, x_j)`` alone:
    each column class ``(c // 4) % 4`` sums its columns in increasing
    order, one FMA a column; classes and the norms are added in class
    order, then ``max((|q|² + |x|²) - 2·dot, 0)``."""
    n = q.shape[1]
    dot = np.zeros((L2_CLASSES, q.shape[0], x.shape[0]), np.float32)
    qn = np.zeros((L2_CLASSES, q.shape[0]), np.float32)
    xn = np.zeros((L2_CLASSES, x.shape[0]), np.float32)
    for c in range(n):
        s = (c // 4) % L2_CLASSES
        dot[s] = _fma32(q[:, c, None], x[None, :, c], dot[s])
        qn[s] = _fma32(q[:, c], q[:, c], qn[s])
        xn[s] = _fma32(x[:, c], x[:, c], xn[s])
    d, a, b = dot[0], qn[0], xn[0]
    for s in range(1, L2_CLASSES):
        d = (d + dot[s]).astype(np.float32)
        a = (a + qn[s]).astype(np.float32)
        b = (b + xn[s]).astype(np.float32)
    return np.maximum(((a[:, None] + b[None, :]).astype(np.float32)
                       - (np.float32(2) * d)).astype(np.float32), 0)


# (Q, X, n): ragged tiles and lengths, several chunks, a length past the ring
L2_TILE = [(1, 1, 1), (17, 31, 3), (33, 40, 97), (5, 70, 64), (40, 33, 130),
           (2, 3, 300), (32, 32, 256)]


@pytest.mark.parametrize("Q,X,n", L2_TILE)
def test_pairwise_l2_tile_model_matches_pair_value_and_twin(Q, X, n):
    """The kernel's tile walk, in both copy instances, gives each pair's
    fixed-order value bit for bit, within 1e-5·(|q|² + |x|²) of the twin."""
    q = RNG.standard_normal((Q, n)).astype(np.float32)
    x = RNG.standard_normal((X, n)).astype(np.float32)
    want = _l2_pair_value(q, x)
    for vec in ((True, False) if n % 4 == 0 else (False,)):
        np.testing.assert_array_equal(_l2_tile_model(q, x, vec), want)
    twin = ops.pairwise_l2(torch.from_numpy(q), torch.from_numpy(x)).numpy()
    scale = (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
    assert (np.abs(want - twin) <= 1e-5 * scale).all()


@pytest.mark.parametrize("Q,X,n,lead_q,lead_x", [
    (17, 31, 3, 5, 37), (33, 40, 97, 31, 1), (5, 70, 64, 1, 2047 % 64),
    (40, 33, 130, 32, 3)])
def test_pairwise_l2_tile_model_is_position_invariant(Q, X, n, lead_q,
                                                      lead_x):
    """The same rows shifted within their tiles and slab (other rows ahead
    of and behind them) give the same bits."""
    q = RNG.standard_normal((Q, n)).astype(np.float32)
    x = RNG.standard_normal((X, n)).astype(np.float32)
    vec = n % 4 == 0
    base = _l2_tile_model(q, x, vec)
    q2 = np.concatenate([RNG.standard_normal((lead_q, n)), q,
                         RNG.standard_normal((3, n))]).astype(np.float32)
    x2 = np.concatenate([RNG.standard_normal((lead_x, n)), x,
                         RNG.standard_normal((7, n))]).astype(np.float32)
    got = _l2_tile_model(q2, x2, vec)[lead_q:lead_q + Q, lead_x:lead_x + X]
    np.testing.assert_array_equal(got, base)


@pytest.mark.parametrize("Q,L,w,n", LB_SWEEP)
def test_lb_isax_twin_matches_pallas(Q, L, w, n):
    _, _, lo, hi = intervals(RNG, Q, L, w)
    pq = RNG.standard_normal((Q, w)).astype(np.float32)
    want = np.asarray(r_lb_isax(jnp.asarray(pq), jnp.asarray(lo),
                                jnp.asarray(hi), n=n, interpret=True))
    got = ops.lb_isax(torch.from_numpy(pq), torch.from_numpy(lo),
                      torch.from_numpy(hi), n).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("Q,L,w,n", [(1, 1, 8, 64), (9, 77, 16, 128),
                                     (3, 600, 8, 64)])
def test_lb_paa_interval_twin_matches_pallas(Q, L, w, n):
    sl, sh, lo, hi = intervals(RNG, Q, L, w)
    want = np.asarray(r_lb_paa_interval(
        jnp.asarray(sl), jnp.asarray(sh), jnp.asarray(lo), jnp.asarray(hi),
        n=n, interpret=True))
    t = [torch.from_numpy(a) for a in (sl, sh, lo, hi)]
    got = ops.lb_paa_interval(*t, n).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_lb_paa_interval_pad_leaf_is_inf_not_nan():
    """The port pads each shard's leaf table with a ``+inf`` leaf (the
    reference's kernel pads tiles with 3e9 instead): the bound there must
    be ``+inf``, never NaN."""
    sl, sh, lo, hi = intervals(RNG, 4, 5, 8)
    lo[-1] = hi[-1] = np.inf
    got = ops.lb_paa_interval(*(torch.from_numpy(a) for a in (sl, sh, lo, hi)),
                              64).numpy()
    assert np.isinf(got[:, -1]).all() and not np.isnan(got).any()
    assert np.isfinite(got[:, :-1]).all()


# lb_paa_interval.cu's map: R = 1 leaf a thread (leaf l0 + tid + r·T),
# QI = 4 queries summed together, the generic instance's 16-column chunks,
# at most 64 queries a block; compiled widths 8 and 16
LBPAA_R, LBPAA_QI, LBPAA_JC, LBPAA_QPB_MAX, LBPAA_SMS = 1, 4, 16, 64, 132


def _lbpaa_launch(Q: int, L: int, w: int, sms: int) -> tuple[int, int]:
    """The launcher's ``(threads a block, queries a block)``."""
    def cdiv(a, b):
        return -(-a // b)
    fixed = w in (8, 16)
    T, qpb = 64, LBPAA_QI
    while (fixed and 2 * qpb <= LBPAA_QPB_MAX
           and cdiv(L, LBPAA_R * T) * cdiv(Q, 2 * qpb) >= 8 * sms):
        qpb *= 2
    if cdiv(L, LBPAA_R * T) * cdiv(Q, qpb) < sms:
        T = 32
    return T, qpb


def _lbpaa_tile_model(sl, sh, lo, hi, n: int, sms: int = LBPAA_SMS
                      ) -> np.ndarray:
    """A numpy walk of ``lb_paa_interval.cu``, every block and thread side
    by side: the launcher's threads and queries a block, the leaf rows each
    thread holds (zero past L), the block's query intervals staged as
    (lo, hi) pairs (zero past Q), or in the generic instance 16-column
    chunks of both (zero past w), each thread's QI × R chains summed column
    by column as ``fl(acc + fl(d·d))`` with ``d = fmax(fmax(lo - qh, ql -
    hi), 0)``, the query groups a block walks, and the store map (each
    bound written once, ``fl(scale · acc)``)."""
    f32 = np.float32
    Q, w = sl.shape
    L = lo.shape[0]
    R, QI, JC = LBPAA_R, LBPAA_QI, LBPAA_JC
    T, qpb = _lbpaa_launch(Q, L, w, sms)
    fixed = w in (8, 16)
    if not fixed:
        assert qpb == QI
    tiles_l = -(-L // (R * T))
    blk = np.arange(tiles_l * -(-Q // qpb))
    l0 = (blk % tiles_l)[:, None] * (R * T) + np.arange(T)    # [B, T]
    q0 = (blk // tiles_l) * qpb                                # [B]
    leaf = l0[:, :, None] + T * np.arange(R)                   # [B, T, R]
    W = w if fixed else JC
    scale = f32(n / w)
    out = np.full((Q, L), np.nan, f32)
    stored = np.zeros((Q, L), int)

    def chunk(tab, rows, ok, j0):
        """``tab[rows, j0:j0+W]`` zero-filled where not ``ok`` or past w."""
        j = j0 + np.arange(W)
        keep = ok[..., None] & (j < w)
        v = tab[np.where(ok, rows, 0)[..., None], np.minimum(j, w - 1)]
        return np.where(keep, v, f32(0)).astype(f32)

    def group(acc, qlo, qhi, rlo, rhi):
        """``acc [B, T, QI, R]`` += columns of ``qlo/qhi [B, QI, W]``
        against ``rlo/rhi [B, T, R, W]``, in column order."""
        for j in range(W):
            a = rlo[:, :, None, :, j] - qhi[:, None, :, None, j]
            b = qlo[:, None, :, None, j] - rhi[:, :, None, :, j]
            d = np.fmax(np.fmax(a, b), f32(0))
            acc = acc + d * d
        return acc

    def store(acc, qg, lf):
        zero = np.zeros(acc.shape, int)
        q = qg[:, None, None, None] + np.arange(QI)[:, None] + zero
        l = lf[:, :, None, :] + zero
        ok = (q < Q) & (l < L)
        out[q[ok], l[ok]] = scale * acc[ok]
        np.add.at(stored, (q[ok], l[ok]), 1)

    lok = leaf < L
    if fixed:
        rlo, rhi = chunk(lo, leaf, lok, 0), chunk(hi, leaf, lok, 0)
        qrow = q0[:, None] + np.arange(qpb)                    # [B, qpb]
        nq = np.minimum(qpb, Q - q0)
        qok = np.arange(qpb) < nq[:, None]
        slo, shi = chunk(sl, qrow, qok, 0), chunk(sh, qrow, qok, 0)
        for g in range(0, qpb, QI):          # a block walks g < its nq
            acc = group(np.zeros((len(blk), T, QI, R), f32),
                        slo[:, g:g + QI], shi[:, g:g + QI], rlo, rhi)
            run = g < nq
            store(acc[run], (q0 + g)[run], leaf[run])
    else:
        acc = np.zeros((len(blk), T, QI, R), f32)
        qrow = q0[:, None] + np.arange(QI)
        qok = qrow < Q
        for j0 in range(0, w, JC):
            acc = group(acc, chunk(sl, qrow, qok, j0),
                        chunk(sh, qrow, qok, j0), chunk(lo, leaf, lok, j0),
                        chunk(hi, leaf, lok, j0))
        store(acc, q0, leaf)
    assert (stored == 1).all()
    return out


# (Q, L, w, sms): widths 1, 3, 8, 16, 17, 32, 33, 64 at leaf counts 1, 757
# and 1500, ragged query groups; sms = 2 makes the launcher take 8 to 64
# queries a block (the fixed widths' walk over several groups)
LBPAA_TILE = [(Q, L, w, sms)
              for i, (w, L) in enumerate((w, L) for w in
                                         (1, 3, 8, 16, 17, 32, 33, 64)
                                         for L in (1, 757, 1500))
              for Q, sms in [((1, 5, 33, 65, 130)[i % 5],
                              2 if i % 3 == 1 else LBPAA_SMS)]]


@pytest.mark.parametrize("Q,L,w,sms", LBPAA_TILE)
def test_lbpaa_tile_model_matches_in_order_twin_and_pallas(Q, L, w, sms):
    """The kernel's map gives the in-order bound of
    ``ref.lb_paa_interval_in_order`` bit for bit (the ``+inf`` pad leaf
    last: ``+inf``, never NaN), within 1e-6 of the twin and of the Pallas
    kernel (interpret mode)."""
    sl, sh, lo, hi = intervals(RNG, Q, L, w)
    lo[-1] = hi[-1] = np.inf
    n = 4 * w + 1
    got = _lbpaa_tile_model(sl, sh, lo, hi, n, sms)
    want = ref.lb_paa_interval_in_order(
        *(torch.from_numpy(a) for a in (sl, sh, lo, hi)), n).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[:, -1]).all() and not np.isnan(got).any()
    twin = ops.lb_paa_interval(*(torch.from_numpy(a)
                                 for a in (sl, sh, lo, hi)), n).numpy()
    np.testing.assert_allclose(got, twin, rtol=1e-6, atol=1e-6)
    pallas = np.asarray(r_lb_paa_interval(
        jnp.asarray(sl), jnp.asarray(sh), jnp.asarray(lo), jnp.asarray(hi),
        n=n, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("w", [8, 16, 33])
def test_lbpaa_tile_model_is_position_invariant(w):
    """The same pairs after other queries and leaves, under other launch
    shapes (threads and queries a block), give the same bits."""
    sl, sh, lo, hi = intervals(RNG, 21, 300, w)
    base = _lbpaa_tile_model(sl, sh, lo, hi, 256)
    for lead_q, lead_l, sms in ((3, 37, 132), (30, 129, 2), (1, 1, 1)):
        a = intervals(RNG, lead_q + 2, lead_l + 5, w)
        got = _lbpaa_tile_model(
            np.concatenate([a[0][:lead_q], sl, a[0][lead_q:]]),
            np.concatenate([a[1][:lead_q], sh, a[1][lead_q:]]),
            np.concatenate([a[2][:lead_l], lo, a[2][lead_l:]]),
            np.concatenate([a[3][:lead_l], hi, a[3][lead_l:]]), 256, sms)
        np.testing.assert_array_equal(
            got[lead_q:lead_q + 21, lead_l:lead_l + 300], base)


# sax_encode.cu's map: tiles of 256 segments (one a thread), a ring of 4
# stages, at most 16 floats of each segment a stage, segments at an odd
# padded stride of copy units, two blocks an SM
SAX_THREADS, SAX_NS, SAX_SC, SAX_SMS = 256, 4, 16, 132


def _sax_stage_model(x: np.ndarray, w: int, b: int, aligned: bool = True,
                     sms: int = SAX_SMS):
    """A numpy walk of ``sax_encode.cu``, block by block: the launcher's
    copy instance (16-byte copies where the segment length is a multiple
    of 4 and ``x`` is aligned, else 4-byte) and grid (one wave, two blocks
    an SM), each block's (tile, chunk) items through the 4-stage ring (a
    slot refilled only once consumed; every staged float written once, at
    segment p, unit u: ``(p·SP + u)·V``, zero past the last segment), each
    thread's segment summed in order across its chunks, divided by its
    length, and the breakpoint count by ``searchsorted``'s binary search;
    each output written once.  Returns ``(paa, sax)``."""
    f32 = np.float32
    B, n = x.shape
    seg = n // w
    pairs = B * w
    flat = x.reshape(-1)
    V = 4 if seg % 4 == 0 and aligned else 1
    SP = (SAX_SC // V + 1) | 1
    assert SP % 2 == 1                       # 32 segments in 32 banks
    STAGE = SAX_THREADS * SP * V
    tiles = -(-pairs // SAX_THREADS)
    grid = min(tiles, 2 * sms)
    chunks = -(-seg // SAX_SC) if seg > 0 else 1
    bp = breakpoints(b).astype(f32)
    paa = np.full(pairs, np.nan, f32)
    sax = np.full(pairs, -1, np.int64)
    written = np.zeros(pairs, int)
    tid = np.arange(SAX_THREADS)
    for blk in range(grid):
        items = -(-(tiles - blk) // grid) * chunks
        ring = np.full((SAX_NS, STAGE), np.nan, f32)
        holds = [-1] * SAX_NS

        def issue(k):
            slot = k % SAX_NS
            assert holds[slot] < k - SAX_NS + 1 or holds[slot] == -1
            holds[slot] = k
            ring[slot] = np.nan
            p0 = (blk + (k // chunks) * grid) * SAX_THREADS
            c0 = (k % chunks) * SAX_SC
            units = min(SAX_SC, seg - c0) // V
            idx = np.arange(SAX_THREADS * units)
            p, u = idx // units, idx % units
            ok = p0 + p < pairs
            for e in range(V):
                src = np.where(ok, (p0 + p) * seg + c0 + u * V + e, 0)
                dst = (p * SP + u) * V + e
                assert np.isnan(ring[slot, dst]).all()      # once each
                ring[slot, dst] = np.where(ok, flat[src], f32(0))

        for k in range(min(SAX_NS - 1, items)):
            issue(k)
        s = np.zeros(SAX_THREADS, f32)
        for k in range(items):
            if k + SAX_NS - 1 < items:
                issue(k + SAX_NS - 1)
            assert holds[k % SAX_NS] == k
            c = k % chunks
            units = min(SAX_SC, seg - c * SAX_SC) // V
            if c == 0:
                s = np.zeros(SAX_THREADS, f32)
            for u in range(units):
                for e in range(V):
                    s = s + ring[k % SAX_NS, (tid * SP + u) * V + e]
            P = (blk + (k // chunks) * grid) * SAX_THREADS + tid
            if c == chunks - 1:
                ok = P < pairs
                m = s / f32(seg)
                lo, hi = np.zeros(SAX_THREADS, int), np.full(SAX_THREADS,
                                                              len(bp))
                while (lo < hi).any():
                    act = lo < hi
                    mid = (lo + hi) >> 1
                    up = act & ~(bp[np.minimum(mid, len(bp) - 1)] > m)
                    lo = np.where(up, mid + 1, lo)
                    hi = np.where(act & ~up, mid, hi)
                paa[P[ok]], sax[P[ok]] = m[ok], lo[ok]
                np.add.at(written, P[ok], 1)
    assert (written == 1).all()
    return paa.reshape(B, w), sax.reshape(B, w)


# (B, n, w, b, aligned, sms): a length not a multiple of 4 (segments of 341
# in 22 chunks, the 4-byte instance), a row off alignment (4-byte instance),
# segments of 8, 25 (4-byte, 2 chunks) and 64 (16-byte, 4 chunks), b in
# {1, 4, 8}, B in {1, 7, 300}; sms = 1 or 2 makes each block walk several
# tiles
SAX_STAGE = [(1, 256, 16, 8, True, 132), (7, 1023, 3, 4, True, 132),
             (300, 256, 16, 1, False, 2), (300, 96, 12, 8, True, 1),
             (7, 100, 4, 4, True, 1), (1, 64, 1, 8, True, 132),
             (300, 64, 8, 4, True, 2), (7, 1023, 3, 8, False, 132),
             (300, 1023, 3, 1, True, 1)]


@pytest.mark.parametrize("B,n,w,b,aligned,sms", SAX_STAGE)
def test_sax_stage_model_matches_in_order_twin_and_pallas(B, n, w, b,
                                                          aligned, sms):
    """The kernel's staged walk gives ``ref.sax_encode_in_order`` bit for
    bit (the in-order PAA and ``searchsorted``'s symbols), within 1e-6 of
    the twin and of the Pallas kernel (interpret mode), its symbols equal
    to theirs away from the breakpoints."""
    x = RNG.standard_normal((B, n)).astype(np.float32)
    paa, sax = _sax_stage_model(x, w, b, aligned, sms)
    want, sym = ref.sax_encode_in_order(torch.from_numpy(x), w, b)
    np.testing.assert_array_equal(paa, want.numpy())
    np.testing.assert_array_equal(sax, sym.numpy())
    clear = clear_of_breakpoints(paa, b)
    twin = ops.sax_encode(torch.from_numpy(x), w, b)
    pallas = r_sax_encode(jnp.asarray(x), w=w, b=b, interpret=True)
    for p_, s_ in ((t.numpy() for t in twin), (np.asarray(a) for a in pallas)):
        np.testing.assert_allclose(paa, p_, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(sax[clear], s_[clear])


def test_sax_stage_model_nan_and_position():
    """A NaN makes its segment's mean NaN and its symbol ``searchsorted``'s
    for NaN (c - 1); the same rows after others, in the other copy
    instance and under another grid give the same bits."""
    x = RNG.standard_normal((40, 256)).astype(np.float32)
    x[3, 17] = x[39, 255] = np.nan
    paa, sax = _sax_stage_model(x, 16, 8)
    want, _ = ref.sax_encode_in_order(torch.from_numpy(x), 16, 8)
    np.testing.assert_array_equal(paa, want.numpy())  # NaN where want's are
    assert np.isnan(paa).sum() == 2 and (sax[np.isnan(paa)] == 255).all()
    for lead, aligned, sms in ((1, True, 132), (37, False, 1), (100, True, 2)):
        pad = RNG.standard_normal((lead, 256)).astype(np.float32)
        got = _sax_stage_model(np.concatenate([pad, x, pad[:3]]), 16, 8,
                               aligned, sms)
        for g, t in zip(got, (paa, sax)):
            np.testing.assert_array_equal(g[lead:lead + 40], t)


@pytest.mark.parametrize("Q,k,C", [(1, 1, 1), (4, 10, 37), (8, 18, 256)])
def test_topk_merge_matches_reference(Q, k, C):
    topd = np.sort(RNG.random((Q, k)).astype(np.float32), axis=1)
    topd[:, k // 2:] = np.inf
    topi = RNG.integers(0, 1000, (Q, k)).astype(np.int32)
    topi[np.isinf(topd)] = -1
    d2 = RNG.random((Q, C)).astype(np.float32)
    d2[RNG.random((Q, C)) < 0.3] = np.inf
    ids = np.where(np.isinf(d2), -1, RNG.integers(1000, 2000, (Q, C))
                   ).astype(np.int32)
    rd, ri = (np.asarray(a) for a in r_ops.topk_merge(
        jnp.asarray(topd), jnp.asarray(topi), jnp.asarray(d2),
        jnp.asarray(ids)))
    pd, pi = ops.topk_merge(*(torch.from_numpy(a)
                              for a in (topd, topi, d2, ids)))
    np.testing.assert_array_equal(pd.numpy(), rd)
    finite = np.isfinite(rd)          # ties only among the +inf/-1 slots
    np.testing.assert_array_equal(pi.numpy()[finite], ri[finite])
    assert pi.dtype == torch.int32


# the Pallas DTW kernels take one query (LB) or a shared block (DP); the
# port's batched forms are held against them query by query
DTW_PALLAS = [(1, 1, 64, 6), (3, 130, 64, 6), (2, 40, 17, 3), (2, 20, 32, 40)]


@pytest.mark.parametrize("Q,m,n,r", DTW_PALLAS)
def test_lb_keogh_and_lb_improved_twins_match_pallas(Q, m, n, r):
    qs, xs, _, U, L = dtw_inputs(RNG, Q, m, n, r)
    t = torch.from_numpy
    lbk = ops.lb_keogh(t(xs), t(U), t(L)).numpy()
    lbi = ops.lb_improved(t(xs), t(qs), t(U), t(L), r).numpy()
    assert lbk.shape == lbi.shape == (Q, m) and not np.isnan(lbi).any()
    for q in range(Q):
        want = np.asarray(r_lb_keogh(jnp.asarray(xs), jnp.asarray(U[q]),
                                     jnp.asarray(L[q]), interpret=True))
        np.testing.assert_allclose(lbk[q], want, rtol=1e-6)
        want = np.asarray(r_lb_improved(
            jnp.asarray(xs), jnp.asarray(qs[q]), jnp.asarray(U[q]),
            jnp.asarray(L[q]), r=r, interpret=True))
        np.testing.assert_allclose(lbi[q], want, rtol=1e-6)


# lb_keogh.cu's tiling: 32-column chunks in a ring of 8 with 7 requested
# ahead, column classes (c // 4) % 4 summed by two warps each, padded staged
# rows; the shared layout's 32 (or 8) x 32 tiles with 4x4 (1x4) register
# tiles (partial-tile stride 40), the per-query layout's 1x64 tiles with one
# pair a thread (stride 64); the launcher takes 32-query tiles while they
# make a block for every two of the card's SMs (132 on an H100)
LBK_KC, LBK_LDK, LBK_NS, LBK_AHEAD, LBK_CLASSES, LBK_SMS = 32, 36, 8, 7, 4, 132


def _lbk_tile_model(x: np.ndarray, U: np.ndarray, L: np.ndarray,
                    vec: bool, tq: int | None = None) -> np.ndarray:
    """A numpy walk of ``lb_keogh.cu``, every block and its 256 threads side
    by side, in the layout ``x`` has (``[m, n]`` shared, ``[Q, m, n]`` per
    query; the shared layout's tile of ``tq`` queries, by default the
    launcher's choice): the copy map of either instance (16-byte copies by
    8 threads a row, or 4-byte copies by 32) of the tile's U rows, L rows
    and candidate rows into the ring slot of each chunk (zero-filled past
    Q, m and n; a never-copied element stays NaN and would show), each
    warp's column class and register rows, ``max(max(v - u, lo - v), 0)``
    and one FMA a column, the partial tiles added in class order through
    the padded epilogue buffer (each slot written once), and the store map
    (each output written once)."""
    Q, n = U.shape
    perq = x.ndim == 3
    m = x.shape[-2]
    assert not vec or n % 4 == 0          # the launcher's choice
    if tq is None and not perq:
        tq = 32 if 2 * -(-m // 32) * -(-Q // 32) >= LBK_SMS else 8
    TQ, TX, XR, RQ, RX, PLD = ((1, 64, 64, 1, 1, 64) if perq
                               else (tq, 32, 32, tq // 8, 4, 40))
    rows, KC, NS, AHEAD = 2 * TQ + XR, LBK_KC, LBK_NS, LBK_AHEAD
    tid = np.arange(256)
    warp, lane = tid >> 5, tid & 31
    cls, w = warp >> 1, warp & 1
    if perq:
        qrow = np.zeros((256, 1), int)
        xrow = (32 * w + lane)[:, None]
    else:
        qrow = ((TQ // 2) * w[:, None] + (lane >> 3)[:, None]
                + 4 * np.arange(RQ))
        xrow = (lane & 7)[:, None] + 8 * np.arange(4)
    tiles_x = -(-m // TX)
    blk = np.arange(tiles_x * -(-Q // TQ))
    q0, x0 = (blk // tiles_x) * TQ, (blk % tiles_x) * TX      # [B]
    B = len(blk)
    chunks = -(-n // KC)
    ring = np.full((NS, B, rows, LBK_LDK), np.nan, np.float32)
    holds = [-1] * NS

    def load(c):
        slot, k0 = ring[c % NS], c * KC
        holds[c % NS] = c
        slot[:, :, :KC] = np.nan
        per_row, width = (KC // 4, 4) if vec else (KC, 1)
        copies = rows * per_row
        for k in range(-(-copies // 256)):
            idx = tid + 256 * k
            idx = idx[idx < copies]
            r, col = idx // per_row, (idx % per_row) * width     # [T]
            isx = r >= 2 * TQ
            q = q0[:, None] + np.where(r < TQ, r, r - TQ)         # [B, T]
            lx = x0[:, None] + r - 2 * TQ
            # a copy tests its row and its first column
            inn = np.where(isx, lx < m, q < Q) & (k0 + col < n)
            qc, lc = np.clip(q, 0, Q - 1), np.clip(lx, 0, m - 1)
            for e in range(width):
                cc = k0 + col + e
                assert (cc[None, :].repeat(B, 0)[inn] < n).all()
                ccc = np.minimum(cc, n - 1)
                xv = (x[q0[:, None], lc, ccc] if perq else x[lc, ccc])
                val = np.where(isx, xv, np.where(r < TQ, U[qc, ccc],
                                                 L[qc, ccc]))
                val = np.where(inn, val, 0).astype(np.float32)
                assert np.isnan(slot[:, r, col + e]).all()    # once each
                slot[:, r, col + e] = val

    for c in range(min(AHEAD, chunks)):
        load(c)
    acc = np.zeros((B, 256, RQ, RX), np.float32)
    for c in range(chunks):
        if c + AHEAD < chunks:
            assert holds[(c + AHEAD) % NS] < c      # a consumed slot
            load(c + AHEAD)
        assert holds[c % NS] == c
        st = ring[c % NS]
        for g in range(KC // 4 // LBK_CLASSES):
            col = 4 * (cls + LBK_CLASSES * g)                   # [256]
            for e in range(4):
                ce = (col + e)[:, None]
                u = st[:, qrow, ce][:, :, :, None]              # [B, 256, i, 1]
                lo = st[:, TQ + qrow, ce][:, :, :, None]
                v = st[:, 2 * TQ + xrow, ce][:, :, None, :]     # [B, 256, 1, j]
                d = np.maximum(np.maximum(v - u, lo - v), np.float32(0))
                acc = _fma32(d, d, acc)
    part = np.full((B, LBK_CLASSES, TQ, PLD), np.nan, np.float32)
    hit = np.zeros(part.shape[1:], int)
    for i in range(RQ):
        for j in range(RX):
            part[:, cls, qrow[:, i], xrow[:, j]] = acc[:, :, i, j]
            hit[cls, qrow[:, i], xrow[:, j]] += 1
    assert (hit[:, :, :TX] == 1).all()
    out = np.full((Q, m), np.nan, np.float32)
    stored = np.zeros((Q, m), int)
    for k in range(-(-TQ * TX // 256)):
        o = tid + 256 * k
        o = o[o < TQ * TX]
        r, cc = o // TX, o % TX
        s = part[:, 0, r, cc]
        for k2 in range(1, LBK_CLASSES):
            s = (s + part[:, k2, r, cc]).astype(np.float32)
        gq, gl = q0[:, None] + r, x0[:, None] + cc
        keep = (gq < Q) & (gl < m)
        out[gq[keep], gl[keep]] = s[keep]
        np.add.at(stored, (gq[keep], gl[keep]), 1)
    assert (stored == 1).all()
    return out


def _lbk_pair_value(x: np.ndarray, U: np.ndarray, L: np.ndarray
                    ) -> np.ndarray:
    """What the kernel must give as a function of ``(x_l, U_q, L_q, n)``
    alone, in the twin's form ``d = max(max(x - U, 0), max(L - x, 0))``:
    each column class ``(c // 4) % 4`` sums ``d²`` over its columns in
    increasing order, one FMA a column from 0, and the classes are added
    in class order.  ``x [m, n]`` or ``[Q, m, n]``."""
    xb = x if x.ndim == 3 else x[None]
    n = U.shape[1]
    acc = np.zeros((LBK_CLASSES, U.shape[0], xb.shape[1]), np.float32)
    for c in range(n):
        s = (c // 4) % LBK_CLASSES
        v = xb[:, :, c]
        d = np.maximum(np.maximum(v - U[:, c, None], np.float32(0)),
                       np.maximum(L[:, c, None] - v, np.float32(0)))
        acc[s] = _fma32(d, d, acc[s])
    out = acc[0]
    for s in range(1, LBK_CLASSES):
        out = (out + acc[s]).astype(np.float32)
    return out


def _lbk_inputs(Q: int, m: int, n: int, swap: bool = False):
    """Random-walk candidates ``[m, n]`` and the envelopes ``(U, L)`` of Q
    random-walk queries (band n // 10) from the port's twin, with the first
    and last column of each envelope infinite; with ``swap`` a run of
    columns has L > U."""
    from repro_torch.core.lb import dtw_envelope_batch
    qs = np.cumsum(RNG.standard_normal((Q, n)), axis=1).astype(np.float32)
    xs = np.cumsum(RNG.standard_normal((m, n)), axis=1).astype(np.float32)
    U, L = (t.numpy().copy() for t in dtw_envelope_batch(
        torch.from_numpy(qs), max(n // 10, 1)))
    U[:, [0, -1]] = np.inf
    L[:, [0, -1]] = -np.inf
    if swap:
        c = slice(n // 3, n // 3 + max(n // 4, 1))
        U[:, c], L[:, c] = L[:, c] - 1, U[:, c] + 1
    return xs, U, L


# (Q, m, n, L > U somewhere): Q in {1, 31, 33, 64} and m in {1, 31, 33,
# 2048} around the 32-row tile, n in {1, 3, 97, 256, 2600}: a column, a
# length not a multiple of 4 (the 4-byte copy instance), several chunks,
# the search's shape, and many turns of the ring
LBK_TILE = [(1, 1, 1, False), (31, 33, 3, False), (33, 31, 97, True),
            (64, 2048, 256, False), (1, 33, 2600, False),
            (33, 1, 256, False), (64, 31, 3, False), (31, 2048, 97, False)]


@pytest.mark.parametrize("Q,m,n,swap", LBK_TILE)
def test_lbk_tile_model_matches_pair_value_twin_and_pallas(Q, m, n, swap):
    """The kernel's tile walk, in both copy instances, both layouts and
    both shared-layout tiles (the launcher's choice and the other), gives
    each pair's fixed-order value bit for bit; the per-query layout
    over a gather of the rows gives the shared layout's bits for the same
    (row, query) pairs; all within 1e-5 of the twin and of the Pallas
    kernel (interpret mode, query 0)."""
    xs, U, L = _lbk_inputs(Q, m, n, swap)
    want = _lbk_pair_value(xs, U, L)
    vecs = (True, False) if n % 4 == 0 else (False,)
    for vec in vecs:
        np.testing.assert_array_equal(_lbk_tile_model(xs, U, L, vec), want)
    other = 8 if 2 * -(-m // 32) * -(-Q // 32) >= LBK_SMS else 32
    np.testing.assert_array_equal(
        _lbk_tile_model(xs, U, L, vecs[0], tq=other), want)
    # per query: each query's candidates a random draw of the rows
    mg = min(m, 97)
    idx = RNG.integers(0, m, (Q, mg))
    for vec in vecs:
        got = _lbk_tile_model(xs[idx], U, L, vec)
        np.testing.assert_array_equal(got, np.take_along_axis(want, idx, 1))
    twin = ops.lb_keogh(torch.from_numpy(xs), torch.from_numpy(U),
                        torch.from_numpy(L)).numpy()
    assert not np.isnan(want).any()
    np.testing.assert_allclose(want, twin, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(r_lb_keogh(jnp.asarray(xs), jnp.asarray(U[0]),
                                   jnp.asarray(L[0]), interpret=True))
    np.testing.assert_allclose(want[0], pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Q,m,n,lead_q,lead_x", [
    (31, 33, 3, 5, 37), (33, 40, 97, 31, 1), (5, 70, 64, 1, 2047 % 64),
    (40, 33, 130, 32, 3)])
def test_lbk_tile_model_is_position_invariant(Q, m, n, lead_q, lead_x):
    """The same rows and envelopes shifted within their tiles and slab
    (other rows ahead of and behind them) give the same bits, in both
    layouts and both shared-layout tiles."""
    xs, U, L = _lbk_inputs(Q, m, n)
    vec = n % 4 == 0
    base = _lbk_tile_model(xs, U, L, vec)
    xo, Uo, Lo = _lbk_inputs(lead_q + 3, lead_x + 7, n)
    U2 = np.concatenate([Uo[:lead_q], U, Uo[lead_q:]])
    L2 = np.concatenate([Lo[:lead_q], L, Lo[lead_q:]])
    x2 = np.concatenate([xo[:lead_x], xs, xo[lead_x:]])
    for tq in (32, 8):
        got = _lbk_tile_model(x2, U2, L2, vec, tq=tq)
        np.testing.assert_array_equal(
            got[lead_q:lead_q + Q, lead_x:lead_x + m], base)
    got = _lbk_tile_model(np.broadcast_to(x2, (Q + lead_q + 3,) + x2.shape),
                          U2, L2, vec)
    np.testing.assert_array_equal(
        got[lead_q:lead_q + Q, lead_x:lead_x + m], base)


def _lbi_stream_model(h: np.ndarray, r: int):
    """numpy model of one ``lb_improved`` kernel thread's window (its index
    arithmetic, line for line; one model thread per row of ``h``): head
    ``j = 0 .. n-1+r`` in chunks of 32, slot ``s = j mod W``, each chunk cut
    into runs with the same HEAD (``j < n``) / OUT (``j >= r``) / TAIL
    (``j >= W``) flags up to a block's last slot (taken four positions at a
    time, every tail read before the head writes), which ``block_end``
    takes: its head, the in-place backward suffix pass, its output.  The
    buffer has the kernel's ``min(2r+1, n)`` slots (an index outside fails)
    and starts as NaN, so a read of a slot not yet written shows as NaN."""
    rows, n = h.shape
    r = min(r, n - 1)                   # the launcher's clamp
    W = 2 * r + 1
    S = min(W, n)
    bmax = np.full((S, rows), np.nan, np.float32)
    bmin = np.full((S, rows), np.nan, np.float32)
    Uh = np.full((rows, n), np.nan, np.float32)
    Lh = np.full((rows, n), np.nan, np.float32)
    written = np.zeros(n, int)
    st = {"pmax": None, "pmin": None}

    def head(j, s):
        assert 0 <= s < S
        bmax[s] = h[:, j]
        st["pmax"] = np.maximum(st["pmax"], h[:, j])
        st["pmin"] = np.minimum(st["pmin"], h[:, j])

    def out(j, uh, lh):
        Uh[:, j - r], Lh[:, j - r] = uh, lh
        written[j - r] += 1

    def run(jb, je, s, is_head, is_out, is_tail):
        # four positions at a time (then one): all tail reads of a batch
        # come before its head writes, as the kernel issues them
        j = jb
        while j < je:
            nb = 4 if j + 4 <= je else 1
            tails = []
            for k in range(nb):
                if is_tail:
                    assert 0 <= s + k + 1 < S
                    tails.append((bmax[s + k + 1].copy(),
                                  bmin[s + k + 1].copy()))
            for k in range(nb):
                if is_head:
                    head(j + k, s + k)
                if is_out:
                    uh, lh = st["pmax"], st["pmin"]
                    if is_tail:
                        uh = np.maximum(uh, tails[k][0])
                        lh = np.minimum(lh, tails[k][1])
                    out(j + k, uh, lh)
            j, s = j + nb, s + nb

    def block_end(j):
        if j < n:
            head(j, W - 1)
        k = min(W - 1, n - 1 - (j - (W - 1)))
        assert 0 <= k < S
        rmax = np.full(rows, -np.inf, np.float32)
        rmin = np.full(rows, np.inf, np.float32)
        for p in range(k, -1, -1):
            rmax = np.maximum(rmax, bmax[p])
            rmin = np.minimum(rmin, bmax[p])
            bmax[p], bmin[p] = rmax, rmin
        out(j, np.maximum(st["pmax"], rmax), np.minimum(st["pmin"], rmin))

    jmax = n - 1 + r
    s = 0
    for j0 in range(0, jmax + 1, 32):
        jend = min(j0 + 32, jmax + 1)
        j = j0
        while j < jend:
            if s == 0:
                st["pmax"] = np.full(rows, -np.inf, np.float32)
                st["pmin"] = np.full(rows, np.inf, np.float32)
            if s == W - 1:
                block_end(j)
                s, j = 0, j + 1
                continue
            e = min(jend, j + (W - 1 - s))
            if j < n:
                e = min(e, n)
            if j < r:
                e = min(e, r)
            if j < W:
                e = min(e, W)
            assert e > j
            run(j, e, s, j < n, j >= r, j >= W)
            s, j = s + e - j, e
    assert (written == 1).all()
    return Uh, Lh


LBI_STREAM = sorted({(n, r) for n in (1, 2, 5, 17, 32, 33, 64, 97)
                     for r in (0, 1, 3, 16, 25, n - 1, n, n + 7) if r >= 0})


@pytest.mark.parametrize("n,r", LBI_STREAM)
def test_lb_improved_stream_model_matches_window_twin(n, r):
    """The kernel's streamed block / suffix / prefix index arithmetic gives
    the twin's sliding max and min bit for bit (r = 0, r >= n and odd n
    included; rounded values give ties)."""
    h = np.round(RNG.standard_normal((6, n)) * 4).astype(np.float32) / 4
    Uh, Lh = _lbi_stream_model(h, r)
    from repro_torch.core.lb import _window_max, _window_min
    np.testing.assert_array_equal(Uh, _window_max(torch.from_numpy(h),
                                                  r).numpy())
    np.testing.assert_array_equal(Lh, _window_min(torch.from_numpy(h),
                                                  r).numpy())


def _dtw_reg_model(qs: np.ndarray, xs: np.ndarray, r: int,
                   cut: np.ndarray) -> np.ndarray:
    """A numpy walk of what ``dtw_band.cu``'s register path does, its 32
    threads a lane side by side, lanes ``qs [L, n]`` against ``xs [L, n]``
    with ``cut [L]``: thread t computes band offset 2t + p of diagonal d
    (p = (d + r) & 1), keeps its cells of d-1 (``c1``) and d-2 (``c2``),
    takes one neighbour's ``c1`` (thread t - 1 + 2p, ``+inf`` past the
    edge), tests the two-diagonal min every 8 diagonals and on the last,
    and reads the result off thread (r - (r & 1)) / 2."""
    L, n = qs.shape
    r = min(r, n - 1)
    assert 2 * r + 1 <= 64
    inf = np.float32(np.inf)
    qT, xT = np.ascontiguousarray(qs.T), np.ascontiguousarray(xs.T)
    t = np.arange(32)
    tfin = (r - (r & 1)) // 2
    # registers [thread, lane]
    c1 = np.full((32, L), inf, np.float32)
    c2 = np.where(t == tfin, np.float32(0), inf)[:, None].repeat(L, 1)
    alive = np.ones(L, bool)
    last = 2 * n - 2
    for d in range(last + 1):
        p = (d + r) & 1
        k = 2 * t + p
        i, j = (d - k + r) >> 1, (d + k - r) >> 1
        valid = (k <= 2 * r) & (i >= 0) & (i < n) & (j >= 0) & (j < n)
        c = (xT[np.clip(j, 0, n - 1)] - qT[np.clip(i, 0, n - 1)]
             ).astype(np.float64)
        src = t - 1 + 2 * p
        nb = c1[src & 31]
        nb[(src < 0) | (src > 31)] = inf
        best = np.minimum(np.minimum(c1, c2), nb)
        v = (c * c + best).astype(np.float32)
        v[~valid] = inf
        lmin = np.minimum(v, c1)
        c2, c1 = c1, v
        if d % 8 == 7 or d == last:
            # the warp's min over the cells' bit patterns
            mn = lmin.view(np.uint32).min(axis=0).view(np.float32)
            alive &= mn <= cut
    return np.where(alive, c1[tfin], inf)


DTW_REG = [c for c in DTW_SWEEP if 2 * min(c[3], c[2] - 1) + 1 <= 64] + [
    (1, 6, 256, 25), (2, 3, 1, 4)]


@pytest.mark.parametrize("Q,m,n,r", DTW_REG)
@pytest.mark.parametrize("cutoff", ["inf", "median"])
def test_dtw_band_register_model_matches_twin(Q, m, n, r, cutoff):
    """The register path's cell-to-thread map, neighbour exchange,
    abandonment tests and final thread give the twin's DP bit for bit,
    ``+inf`` lanes included (n = 1, r = 0 and r >= n among the cases)."""
    qs, xs, _, _, _ = dtw_inputs(RNG, Q, m, n, r)
    t = torch.from_numpy
    on = np.ones((Q, m), bool)
    full = ops.dtw_band(t(qs), t(xs), t(on), t(np.full(Q, np.inf,
                                                       np.float32)), r)
    cut = (np.full(Q, np.inf, np.float32) if cutoff == "inf" else
           np.median(full.numpy(), axis=1).astype(np.float32))
    want = full if cutoff == "inf" else ops.dtw_band(t(qs), t(xs), t(on),
                                                     t(cut), r)
    got = _dtw_reg_model(np.repeat(qs, m, axis=0), np.tile(xs, (Q, 1)), r,
                         np.repeat(cut, m))
    np.testing.assert_array_equal(got.reshape(Q, m), want.numpy())
    if cutoff == "median" and m > 1:
        assert np.isinf(got).any() and np.isfinite(got).any()


def test_dtw_band_takes_any_band_radius():
    """r >= n and r past the shared-memory cap of the first CUDA kernel
    (r >= 2418) give the full-band DTW, as r = n - 1 does."""
    qs, xs, _, _, _ = dtw_inputs(RNG, 3, 20, 40, 39)
    mask = RNG.random((3, 20)) < 0.7
    cut = np.full(3, np.inf, np.float32)
    t = torch.from_numpy
    want = ops.dtw_band(t(qs), t(xs), t(mask), t(cut), 39)
    for r in (40, 100, 2418, 5000):
        got = ops.dtw_band(t(qs), t(xs), t(mask), t(cut), r)
        assert torch.equal(got, want)
    assert torch.isfinite(want[t(mask)]).all()
    assert torch.isinf(want[~t(mask)]).all()


def test_dtw_twin_counts_the_diagonals_each_lane_ran():
    """``return_steps``: 0 on masked lanes, 2n - 1 on lanes that finish,
    at least one on abandoned ones; the distances are unchanged."""
    from repro_torch.core.lb import dtw2_masked_gather
    Q, m, n, r = 4, 30, 64, 6
    rng = np.random.default_rng(7)
    qs, xs, _, _, _ = dtw_inputs(rng, Q, m, n, r)
    mask, cut = dtw_mask_cutoff(rng, qs, xs, r)
    t = torch.from_numpy
    cand = t(xs)[None].expand(Q, -1, -1)
    out, steps = dtw2_masked_gather(t(qs), cand, r, t(mask), t(cut),
                                    return_steps=True)
    assert torch.equal(out, dtw2_masked_gather(t(qs), cand, r, t(mask),
                                               t(cut)))
    steps, out = steps.numpy(), out.numpy()
    assert (steps[~mask] == 0).all()
    assert (steps[np.isfinite(out)] == 2 * n - 1).all()
    dead = mask & np.isinf(out)
    assert dead.any() and (steps[dead] >= 1).all()
    assert (steps[dead] < 2 * n - 1).any()


@pytest.mark.parametrize("Q,m,n,r", DTW_PALLAS)
def test_dtw_band_twin_matches_pallas_bitwise(Q, m, n, r):
    """The twin's band-compacted DP against the Pallas kernel's full-width
    one: the same cells, so the same values and the same ``+inf`` lanes."""
    qs, xs, _, _, _ = dtw_inputs(RNG, Q, m, n, r)
    mask, cut = dtw_mask_cutoff(RNG, qs, xs, r)
    want = np.asarray(r_dtw_band(jnp.asarray(qs), jnp.asarray(xs),
                                 jnp.asarray(mask), jnp.asarray(cut), r=r,
                                 interpret=True))
    t = torch.from_numpy
    got = ops.dtw_band(t(qs), t(xs), t(mask), t(cut), r).numpy()
    np.testing.assert_array_equal(got, want)
    if m > 1:
        assert np.isinf(got).any() and np.isfinite(got).any()


def test_dtw_band_row_table_is_the_gather():
    """Rows ``idx [Q, m]`` of a collection give what the gathered
    ``[Q, m, n]`` candidate sets give."""
    qs, xs, _, _, _ = dtw_inputs(RNG, 3, 50, 64, 6)
    idx = RNG.integers(0, 50, (3, 20))
    mask = RNG.random((3, 20)) < 0.8
    cut = np.full(3, 2000.0, np.float32)
    t = torch.from_numpy
    got = ops.dtw_band(t(qs), t(xs), t(mask), t(cut), 6, idx=t(idx))
    want = ops.dtw_band(t(qs), t(xs[idx]), t(mask), t(cut), 6)
    assert torch.equal(got, want)


@pytest.mark.parametrize("X,n,k", [(100, 64, 3), (333, 96, 10), (5, 64, 9)])
def test_knn_from_leaves_matches_reference(X, n, k):
    """``ops.knn_from_leaves`` on the CPU (``pairwise_l2``'s twin, then a
    stable sort) against the reference's (its Pallas ``pairwise_l2`` in
    interpret mode, then ``lax.top_k``), as ``test_kernels.py`` calls it:
    the query's own row first at distance ~0; distances within rtol 1e-5
    (atol 1e-4: the row at ~0), ids equal except between such ties.  Rows
    repeated twice give exact ties, which keep the lower position first in
    both packages."""
    x = RNG.standard_normal((X, n)).astype(np.float32)
    x[X // 2] = x[X // 3]                    # an exact tie
    for qi in (0, X // 3):
        r_ids, r_d2 = (np.asarray(a) for a in r_ops.knn_from_leaves(
            jnp.asarray(x[qi]), jnp.asarray(x), k))
        ids, d2 = ops.knn_from_leaves(torch.from_numpy(x[qi]),
                                      torch.from_numpy(x), k)
        assert ids.shape == d2.shape == (min(k, X),)
        assert int(ids[0]) == qi
        np.testing.assert_allclose(d2.numpy(), r_d2, rtol=1e-5, atol=1e-4)
        for j in np.nonzero(ids.numpy() != r_ids)[0]:
            assert np.isclose(r_d2[j], r_d2[j - 1 if j else 1], rtol=1e-5,
                              atol=1e-4), (j, ids, r_ids, r_d2)
    ids, _ = ops.knn_from_leaves(torch.from_numpy(x[X // 3]),
                                 torch.from_numpy(x), 2)
    assert ids.tolist() == sorted({X // 3, X // 2})


def test_ops_routes_cpu_tensors_to_twins():
    """A CPU tensor goes to the twin and launches nothing; the kernel
    wrappers themselves refuse CPU tensors (no silent fallback)."""
    mods = (sax_encode, pairwise_l2, lb_isax, lb_keogh, lb_improved,
            dtw_band)
    counts = [m.launches for m in mods]
    x = torch.from_numpy(RNG.standard_normal((5, 64)).astype(np.float32))
    paa, sax = ops.sax_encode(x, 8, 8)
    ops.pairwise_l2(x, x)
    ops.lb_isax(paa, paa, paa, 64)
    ops.lb_keogh(x, x, x)
    ops.lb_improved(x, x, x, x, 3)
    mask = torch.ones((5, 5), dtype=torch.bool)
    cut = torch.full((5,), np.inf)
    ops.dtw_band(x, x, mask, cut, 3)
    assert [m.launches for m in mods] == counts
    with pytest.raises(ValueError, match="CUDA"):
        sax_encode.sax_encode(x, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_l2.pairwise_l2(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        lb_isax.lb_paa_interval(paa, paa, paa, paa, 64)
    with pytest.raises(ValueError, match="CUDA"):
        lb_keogh.lb_keogh(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        lb_improved.lb_improved(x, x, x, x, 3)
    with pytest.raises(ValueError, match="CUDA"):
        dtw_band.dtw_band(x, x, mask, cut, 3)


def test_kernel_library_is_keyed_on_sources_and_flags(monkeypatch):
    """The built library's name carries a hash of the sources and flags, so
    an edited source rebuilds; it lives under the repository's build/."""
    from repro_torch.kernels import _build
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    assert all((_build.CSRC / s).is_file() for s in _build.SOURCES)
    monkeypatch.setattr(_build, "FLAGS", _build.FLAGS + ("-lineinfo",))
    assert _build.library_path() != path
