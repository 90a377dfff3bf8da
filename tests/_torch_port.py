"""Shared helpers of the ``test_torch_*`` files, which hold the PyTorch port
(``repro_torch``) against the JAX reference (``repro``) on the same inputs.

* :func:`torch_threads` — module-scoped fixture capping torch's intra-op
  threads, so several pytest-xdist workers do not oversubscribe the cores;
* :func:`cuda` — fixture for tests that need the card: it skips, with a
  reason, where CUDA is absent (decided when the test runs, never at
  import, so every worker collects the same tests);
* :func:`build_pair` — the same data and parameters built by both packages
  (the only helper that imports the reference; the card's tests import no
  ``jax``, so they run where JAX is not installed);
* :func:`assert_ties_only` — the rtol rule for answers that each package
  sums in its own float32 order;
* :func:`model_reference` — one reduced architecture run through the
  reference (parameters, batch, train logits, loss, prefill and decode),
  once per process, for the ``test_torch_models_*`` files.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

TORCH_THREADS = 2

# the shape sweeps of tests/test_kernels.py
SAX_SWEEP = [(B, n, w, b) for B in (1, 7, 256, 300)
             for n, w in ((64, 8), (128, 16), (256, 16), (96, 12))
             for b in (4, 8)]
L2_SWEEP = [(1, 1, 64), (17, 333, 96), (128, 128, 128), (5, 1000, 256),
            (130, 50, 320)]
# cuda-only pairwise_l2 cases (Q, X, n): lengths not a multiple of 4 (the
# 4-byte copy instance), the search's 256, and one long enough for many
# turns of the 8-chunk ring; ragged tiles of Q and X with each length
L2_CUDA_EDGES = [(Q, X, n) for n in (1, 3, 97, 256, 2600)
                 for Q, X in ((1, 1), (17, 333), (64, 2048), (65, 31),
                              (130, 333))]
# cuda-only lb_keogh cases (Q, m, n): Q and m on both sides of the 32-row
# tile (and of the per-query layout's 64-row tile), lengths not a multiple
# of 4 (the 4-byte copy instance), the search's 256, a row long enough for
# many turns of the 8-chunk ring, and one longer than the first kernel could
# stage in shared memory (n > 58 112)
LBK_CUDA_EDGES = [(Q, m, n) for n in (1, 3, 97, 256, 2600)
                  for Q, m in ((1, 1), (31, 33), (33, 31), (64, 2048),
                               (65, 97))] + [(1, 3, 60000)]
LB_SWEEP = [(1, 1, 8, 64), (9, 77, 16, 128), (8, 512, 16, 256),
            (3, 1500, 8, 64)]
# cuda-only lb_paa_interval cases (Q, L, w): the generic instance's widths
# (1, 3, 17, 33, 64; 64 past the first kernel's limit of 32), the compiled
# 8 and 16 with ragged query groups and leaf tiles, the search's
# [64, 757, 16], a 100 M-series collection's table [256, 18 925, 16], and
# empty Q or L
LBPAA_CUDA_EDGES = [(1, 1, 1), (5, 333, 3), (9, 77, 64), (3, 700, 64),
                    (33, 1500, 33), (64, 757, 17), (130, 1500, 8),
                    (5, 1, 16), (64, 757, 16), (256, 18925, 16),
                    (0, 50, 16), (7, 0, 16), (0, 0, 64)]
# cuda-only sax_encode cases (B, n, w, b): a length not a multiple of 4
# (segments of 341, the 4-byte copy instance), segments not a multiple of
# 4, segments of 15 000 floats (many staged chunks), b = 1, 100 000 rows
# (many tiles a block), and no rows
SAX_CUDA_EDGES = [(7, 1023, 3, 4), (300, 96, 12, 8), (5, 60000, 4, 8),
                  (1, 256, 16, 1), (33, 64, 8, 8), (100_000, 256, 16, 8),
                  (0, 256, 16, 8)]
# (Q, m, n, r) of the DTW cascade kernels: the search's shapes (n=256,
# r=25 with a 256-row sub-slab or a 128-lane gather chunk), ragged ones,
# and the full-width band r + 1 >= n
DTW_SWEEP = [(1, 1, 64, 6), (5, 77, 64, 6), (64, 256, 256, 25),
             (64, 128, 256, 25), (3, 40, 17, 3), (4, 33, 64, 63),
             (2, 9, 32, 40), (7, 50, 96, 0)]
# cuda-only DTW cases, outside the Pallas sweep (its interpret run at long
# n takes minutes on a CPU): (Q, m, n, r, share of lanes on): both sides
# of dtw_band's register/wide split (2r+1 <= 64), a lane-walk call (16
# queries x 128 lanes, ~45% on), a band past the first CUDA kernel's
# shared-memory cap (r >= 2418; the frontier in device scratch), and a
# call with every lane masked off
DTW_CUDA_EDGES = [(3, 40, 96, 31, 0.7), (3, 40, 96, 32, 0.7),
                  (16, 128, 256, 25, 0.45), (2, 5, 2600, 2500, 0.7),
                  (4, 33, 64, 6, 0.0)]
# lb_improved's tiling (a thread per pair: lane = candidate, warp = query,
# 32 candidates a block): DTW_SWEEP plus Q not a multiple of 32, m not a
# multiple of the 32-candidate tile, a long row with a wide band, r = 1,
# and a band so wide that a warp runs fewer than 32 lanes
LBI_SWEEP = DTW_SWEEP + [(33, 40, 64, 6), (65, 100, 256, 25),
                         (4, 1, 256, 25), (5, 7, 256, 25),
                         (2, 2047, 256, 25), (3, 20, 1024, 102),
                         (6, 45, 128, 1), (2, 5, 1800, 900)]


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: "
                    "python -m pytest -m cuda tests/test_torch_kernels_cuda.py)")
    return torch.device("cuda")


def clear_of_breakpoints(paa: np.ndarray, b: int, gap: float = 1e-5):
    """Where the PAA lies more than ``gap`` from every breakpoint (symbols
    must agree there whatever the summation order)."""
    from repro_torch.core.sax import breakpoints
    return np.abs(paa[..., None] - breakpoints(b)).min(axis=-1) > gap


def intervals(rng, Q: int, L: int, w: int):
    """Random query intervals ``[Q, w]`` and regions ``[L, w]`` (lo ≤ hi)."""
    lo = rng.standard_normal((L, w)).astype(np.float32)
    hi = lo + np.abs(rng.standard_normal((L, w))).astype(np.float32)
    sl = rng.standard_normal((Q, w)).astype(np.float32)
    sh = sl + np.abs(rng.standard_normal((Q, w))).astype(np.float32)
    return sl, sh, lo, hi


def dtw_inputs(rng, Q: int, m: int, n: int, r: int):
    """Random-walk queries ``[Q, n]``, candidates ``[m, n]`` and per-query
    candidates ``[Q, m, n]``, with the queries' envelopes ``(U, L)`` from
    the port's twin; the first and last column of every envelope are set
    to ``±inf`` (an unbounded edge must give 0, never NaN)."""
    from repro_torch.core.lb import dtw_envelope_batch
    qs = np.cumsum(rng.standard_normal((Q, n)), axis=1).astype(np.float32)
    xs = np.cumsum(rng.standard_normal((m, n)), axis=1).astype(np.float32)
    cand = np.cumsum(rng.standard_normal((Q, m, n)), axis=2
                     ).astype(np.float32)
    U, L = (t.numpy().copy() for t in dtw_envelope_batch(
        torch.from_numpy(qs), r))
    U[:, [0, -1]] = np.inf
    L[:, [0, -1]] = -np.inf
    return qs, xs, cand, U, L


def dtw_mask_cutoff(rng, qs, xs, r: int, on: float = 0.7):
    """A random lane mask ``[Q, m]`` (a share ``on`` of lanes on) and
    per-query cutoffs at the lower quartile of the unmasked DTW² (so some
    lanes finish and some are abandoned), from the port's twin on the
    CPU."""
    from repro_torch.kernels.ref import dtw_band_ref
    Q, m = qs.shape[0], xs.shape[-2]
    mask = rng.random((Q, m)) < on
    t = torch.from_numpy
    full = dtw_band_ref(t(qs), t(xs), torch.ones((Q, m), dtype=torch.bool),
                        torch.full((Q,), np.inf), r).numpy()
    cut = np.quantile(full, 0.25, axis=1).astype(np.float32)
    return mask, cut


def assert_ties_only(ids, d, r_ids, r_d, rtol: float = 1e-5):
    """Two packages' ``[Q, k]`` answers from their own float32 sums:
    distances within ``rtol`` (``+inf`` slots in the same places), ids
    equal except at positions whose distance is tied (within ``rtol``)
    with a neighbouring position, where the tied ids may swap."""
    np.testing.assert_array_equal(np.isinf(d), np.isinf(r_d))
    fin = np.isfinite(r_d)
    np.testing.assert_allclose(d[fin], r_d[fin], rtol=rtol, atol=0)
    for qi, j in zip(*np.nonzero(ids != r_ids)):
        near = [r_d[qi, jj] for jj in (j - 1, j + 1) if 0 <= jj < d.shape[1]]
        assert any(abs(x - r_d[qi, j]) <= rtol * r_d[qi, j] for x in near), \
            (qi, j, ids[qi], r_ids[qi], r_d[qi])


def params_pair(w: int = 8, b: int = 8, th: int = 128, fuzzy_f: float = 0.0):
    """``(reference DumpyParams, port DumpyParams)`` with equal fields."""
    from repro.core.build import DumpyParams as RParams
    from repro.core.sax import SaxParams as RSax
    from repro.core.split import SplitParams as RSplit
    from repro_torch.core.build import DumpyParams
    from repro_torch.core.sax import SaxParams
    from repro_torch.core.split import SplitParams
    return (RParams(sax=RSax(w=w, b=b), split=RSplit(th=th), fuzzy_f=fuzzy_f),
            DumpyParams(sax=SaxParams(w=w, b=b), split=SplitParams(th=th),
                        fuzzy_f=fuzzy_f))


def build_pair(db: np.ndarray, **kw):
    """``(reference DumpyIndex, port DumpyIndex)`` over the same ``db``."""
    from repro.core.index import DumpyIndex as RIndex
    from repro_torch.core.index import DumpyIndex
    rp, pp = params_pair(**kw)
    return RIndex.build(db, rp), DumpyIndex.build(db, pp)


# ---------------------------------------------------------------------------
# the LM substrate
# ---------------------------------------------------------------------------

MODEL_B, MODEL_S = 2, 32        # tests/test_models.py's batch and length


def model_batch(cfg) -> dict:
    """``tests/test_models.py``'s batch as numpy arrays."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (MODEL_B, MODEL_S)
                                    ).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (MODEL_B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (MODEL_B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def torch_batch(batch: dict, device="cpu") -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def grow_reference_cache(cache: dict) -> dict:
    """Grow the prefill caches of ``S - 1`` tokens by one slot, as
    ``tests/test_models.py`` does before its decode step."""
    def grow(x):
        if x.ndim == 5 and x.shape[2] == MODEL_S - 1:   # [L, B, S-1, KV, Dh]
            return np.pad(x, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0)))
        if x.ndim == 4 and x.shape[1] == MODEL_S - 1:   # remainder blocks
            return np.pad(x, ((0, 0), (0, 1), (0, 0), (0, 0)))
        return x
    return {k: grow_reference_cache(v) if isinstance(v, dict) else grow(v)
            for k, v in cache.items()}


_MODEL_RUNS: dict = {}


def model_reference(name: str, ulp: bool = False) -> dict:
    """The reduced ``name`` run through the reference (jitted) on its own
    parameters (``PRNGKey(0)``) and ``model_batch``: numpy ``params``,
    ``batch``, ``logits`` (train), ``loss``, ``prefill_logits``,
    ``prefill_cache`` (of ``S - 1`` tokens), ``grown_cache`` and the
    decode of token ``S - 1`` (``decode_logits``, ``decode_cache``).
    With ``ulp``, the same run with the embedding table scaled by
    (1 + 2^-23), one float32 ulp."""
    if (name, ulp) in _MODEL_RUNS:
        return _MODEL_RUNS[(name, ulp)]
    import jax
    import jax.numpy as jnp
    from repro.configs.base import reduced
    from repro.models import registry, transformer as tfm
    cfg = reduced(registry.get_config(name))
    params = tfm.init_params(cfg, jax.random.PRNGKey(0))
    if ulp:
        params["embed"] = params["embed"] * (1 + 2.0 ** -23)
    batch = model_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits = jax.jit(lambda p, b: tfm.forward_train(p, b, cfg))(params, jb)
    loss = jax.jit(lambda p, b: registry.loss_fn(p, b, cfg))(params, jb)
    pre = dict(jb, tokens=jb["tokens"][:, :MODEL_S - 1])
    plog, pcache = jax.jit(lambda p, b: tfm.forward_prefill(p, b, cfg))(
        params, pre)
    to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    grown = grow_reference_cache(to_np(pcache))
    tok = jb["tokens"][:, MODEL_S - 1:MODEL_S]
    dlog, dcache = jax.jit(lambda p, c, t: tfm.forward_decode(
        p, c, t, jnp.int32(MODEL_S - 1), cfg))(
        params, jax.tree.map(jnp.asarray, grown), tok)
    run = {"cfg": cfg, "params": to_np(params), "batch": batch,
           "logits": np.asarray(logits), "loss": float(loss),
           "prefill_logits": np.asarray(plog), "prefill_cache": to_np(pcache),
           "grown_cache": grown, "decode_logits": np.asarray(dlog),
           "decode_cache": to_np(dcache)}
    _MODEL_RUNS[(name, ulp)] = run
    return run


# atol = rtol of the port against the reference on the reduced configs.
# Everything that runs on the same float32 operations in another order
# agrees to 1e-4 (measured: 3e-6 to 2e-5 on the logits), except the two
# recurrent families, whose reduced models are ill-conditioned at the
# reference's own init (std 1 weights: the stacked leaves' 1/sqrt(n_units)
# with one unit):
# * recurrentgemma-9b (measured 7.3e-4 on the logits): b = sqrt(1 - a²)·…
#   at a ≈ 0.999 turns a one-ulp difference of exp into ~6e-5 of b, and the
#   std-1 weights carry it on;
# * xlstm-1.3b: the reference itself moves as far as the port is from it
#   when its embedding table is scaled by one float32 ulp (7.4e-3 on the
#   logits, up to 1.4e-2 of the sLSTM state), through eight blocks of
#   std-1 weights and the mLSTM's cancelling normalizer.  So every array
#   is held to twice the reference's own movement (``ULP_BOUND``), and
#   the logits also to 2e-2, the reference's prefill-vs-train tolerance.
MODEL_TOL = {"recurrentgemma-9b": 2e-3, "xlstm-1.3b": 2e-2}
ULP_BOUND = {"xlstm-1.3b"}


def model_tol(name: str) -> float:
    return MODEL_TOL.get(name, 1e-4)


def assert_model_close(name: str, got, key: str, what: str) -> None:
    """The port's ``got`` (an array or a cache tree in the reference's
    layout) against ``model_reference(name)[key]``: atol = rtol =
    ``model_tol``; for ``ULP_BOUND`` also max |Δ| of every leaf within
    2 · (the reference's own one-ulp movement) + 1e-5 of its magnitude
    (caches only that)."""
    want = model_reference(name)[key]
    if name not in ULP_BOUND:
        assert_tree_close(got, want, model_tol(name), what)
        return
    moved = model_reference(name, ulp=True)[key]
    if not isinstance(want, dict):                   # logits
        assert_tree_close(got, want, model_tol(name), what)

    def leaf(g, w, m, at):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (at, g.shape, w.shape)
        err = float(np.abs(g - w).max(initial=0.0))
        own = float(np.abs(np.asarray(m) - w).max(initial=0.0))
        scale = max(float(np.abs(w).max(initial=0.0)), 1.0)
        assert err <= 2 * own + 1e-5 * scale, (at, err, own)

    def walk(g, w, m, at):
        if not isinstance(w, dict):
            return leaf(g, w, m, at)
        assert sorted(g) == sorted(w), (at, sorted(g), sorted(w))
        for k in w:
            walk(g[k], w[k], m[k], f"{at}/{k}")
    walk(got, want, moved, what)


def port_model(name: str, device="cpu"):
    """The port's model of the reduced ``name`` on the reference's own
    parameters."""
    from repro_torch.configs.base import reduced
    from repro_torch.models import registry, weights
    cfg = reduced(registry.get_config(name))
    return weights.model_from_reference(cfg, model_reference(name)["params"],
                                        device)


def assert_tree_close(got, want, tol: float, what: str) -> None:
    """Every leaf of ``got`` allclose to ``want`` (atol = rtol = tol), and
    the two trees of the same keys and shapes."""
    if not isinstance(want, dict):
        assert got.shape == np.shape(want), (what, got.shape, np.shape(want))
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol, err_msg=what)
        return
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        assert_tree_close(got[k], want[k], tol, f"{what}/{k}")


def check_train_and_loss(name: str) -> None:
    from repro_torch.models import registry, transformer as tfm
    ref = model_reference(name)
    model = port_model(name)
    batch = torch_batch(ref["batch"])
    with torch.no_grad():
        logits = tfm.forward_train(model, batch).numpy()
        loss = float(registry.loss_fn(model, batch))
    assert_model_close(name, logits, "logits", "train logits")
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)


def check_prefill(name: str) -> None:
    from repro_torch.models import transformer as tfm, weights
    ref = model_reference(name)
    model = port_model(name)
    batch = torch_batch(ref["batch"])
    batch["tokens"] = batch["tokens"][:, :MODEL_S - 1]
    with torch.no_grad():
        logits, caches = tfm.forward_prefill(model, batch)
    assert_model_close(name, logits.numpy(), "prefill_logits",
                       "prefill logits")
    assert_model_close(name, weights.cache_to_reference(caches),
                       "prefill_cache", "prefill cache")


def check_decode(name: str) -> None:
    """The reference's grown prefill cache through the port's decode."""
    from repro_torch.models import transformer as tfm, weights
    ref = model_reference(name)
    model = port_model(name)
    caches = weights.cache_from_reference(model.cfg, ref["grown_cache"],
                                          "cpu")
    tok = torch.from_numpy(ref["batch"]["tokens"][:, MODEL_S - 1:MODEL_S])
    with torch.no_grad():
        logits, new = tfm.forward_decode(model, caches, tok, MODEL_S - 1)
    assert_model_close(name, logits.numpy(), "decode_logits",
                       "decode logits")
    assert_model_close(name, weights.cache_to_reference(new),
                       "decode_cache", "decode cache")


def check_prefill_decode_consistency(name: str) -> None:
    """Twin of tests/test_models.py's consistency test on the port's own
    parameters: decoding token t with the prefill cache of tokens [0..t)
    matches the full forward's logits at t."""
    from repro_torch.configs.base import reduced
    from repro_torch.models import registry, transformer as tfm
    cfg = reduced(registry.get_config(name))
    model = tfm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = torch_batch(model_batch(cfg))
    with torch.no_grad():
        full = tfm.forward_train(model, batch).numpy()
        pre = dict(batch, tokens=batch["tokens"][:, :MODEL_S - 1])
        last, caches = tfm.forward_prefill(model, pre)
        np.testing.assert_allclose(last[:, 0].numpy(), full[:, MODEL_S - 2],
                                   atol=2e-2, rtol=2e-2)
        caches = tfm.grow_cache(caches, MODEL_S - 1, MODEL_S)
        tok = batch["tokens"][:, MODEL_S - 1:MODEL_S]
        dec, _ = tfm.forward_decode(model, caches, tok, MODEL_S - 1)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, MODEL_S - 1],
                               atol=7e-2, rtol=5e-2)


def port_grads(model, batch: dict) -> float:
    """Backpropagate the port's loss; the sum of |grad| over all leaves."""
    from repro_torch.models import registry
    model.zero_grad()
    registry.loss_fn(model, batch).backward()
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None for g in grads)
    return float(sum(g.abs().sum() for g in grads))
