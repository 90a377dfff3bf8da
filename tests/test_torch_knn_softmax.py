"""The port's kNN-softmax head (``repro_torch.serving.knn_softmax``) on the
CPU (``device="cpu"``): twins of ``tests/test_distributed.py``'s
``test_knn_softmax_mips_reduction_exactness`` and
``test_knn_softmax_head_end_to_end``, and the port's head against the
reference's on one seeded ``lm_head``.

Tolerances.  The host path (``candidates``: the host ``extended_search``)
is bitwise the reference's.  The batched path (``candidates_batch``:
``extended_search_device_batch(rerank=False)``) ranks by each package's own
float32 sums: leaf schedules bitwise, distances within rtol 1e-5, ids
moving only between tied distances (``assert_ties_only``).  Tokens come
from the same host numpy in both packages; ``step_batch_via`` (through a
coalescing front-end) gives exactly ``step_batch``'s tokens."""
import numpy as np
import pytest

from _torch_port import assert_ties_only, torch_threads  # noqa: F401
from repro.core.search_device import extended_search_device_batch as r_ext
from repro.serving.knn_softmax import KnnSoftmaxHead as RHead
from repro_torch.core.search_device import extended_search_device_batch
from repro_torch.serving.knn_softmax import KnnSoftmaxHead

CPU = "cpu"
D, VOCAB = 32, 2048
HEAD_KW = dict(w=8, th=128, r_candidates=64, nbr_nodes=4)


@pytest.fixture(scope="module")
def lm_head():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((D, VOCAB)) / np.sqrt(D)).astype(np.float32)


@pytest.fixture(scope="module")
def heads(lm_head):
    """(reference head, port head) over the same ``lm_head``."""
    return RHead(lm_head, **HEAD_KW), KnnSoftmaxHead(lm_head, device=CPU,
                                                      **HEAD_KW)


@pytest.fixture(scope="module")
def hidden(lm_head):
    """Eight hidden states near seeded vocabulary rows."""
    rng = np.random.default_rng(6)
    t = rng.integers(VOCAB, size=8)
    return (lm_head[:, t].T
            + 0.3 * rng.standard_normal((8, D)) / np.sqrt(D)
            ).astype(np.float32)


def test_knn_softmax_mips_reduction_exactness():
    """The head's augmentation, isotropic scaling and zero padding make the
    L2 order over its indexed rows equal the inner-product order."""
    rng = np.random.default_rng(0)
    d, vocab = 16, 400
    W = rng.standard_normal((d, vocab)).astype(np.float32)
    W *= rng.uniform(0.5, 2.0, vocab)[None, :]     # spread the norms
    head = KnnSoftmaxHead(W, w=8, th=64, r_candidates=16, nbr_nodes=2,
                          device=CPU)
    rows = head.index.db.astype(np.float64)         # [vocab, padded d+1]
    assert rows.shape == (vocab, d + 1 + head.pad)
    for _ in range(5):
        h = rng.standard_normal(d).astype(np.float32)
        qp = head._encode_queries(h[None])[0].astype(np.float64)
        ip_order = np.argsort(-(h.astype(np.float64) @ W))
        l2_order = np.argsort(((rows - qp) ** 2).sum(1))
        np.testing.assert_array_equal(ip_order[:20], l2_order[:20])


def test_knn_softmax_head_end_to_end():
    rng = np.random.default_rng(0)
    W = rng.standard_normal((32, 2048)).astype(np.float32)
    head = KnnSoftmaxHead(W, w=8, th=128, r_candidates=256, nbr_nodes=8,
                          device=CPU)
    for _ in range(20):
        t = rng.integers(2048)
        h = W[:, t] + 0.1 * rng.standard_normal(32).astype(np.float32)
        head.step(h)
    s = head.stats
    assert s.tokens == 20
    assert s.exact_in_topr / s.tokens >= 0.5       # retrieval works


def test_host_candidates_bitwise_equal_reference(heads, hidden):
    rh, ph = heads
    np.testing.assert_array_equal(ph.mu, rh.mu)
    assert ph.sd == rh.sd and ph.pad == rh.pad
    np.testing.assert_array_equal(ph.index.db, rh.index.db)
    for h in hidden:
        np.testing.assert_array_equal(ph.candidates(h), rh.candidates(h))


def test_candidates_batch_matches_reference(heads, hidden):
    """``candidates_batch`` is the batched extended search without the host
    re-rank; against the reference: schedules bitwise, ids ties-only."""
    rh, ph = heads
    cand = ph.candidates_batch(hidden)
    qp = ph._encode_queries(hidden)
    np.testing.assert_array_equal(qp, rh._encode_queries(hidden))
    ids, d, leaves = extended_search_device_batch(
        ph.index, qp, ph.r, nbr=ph.nbr, rerank=False, metric=ph.metric,
        device=CPU)
    np.testing.assert_array_equal(cand, ids)
    r_ids, r_d, r_leaves = (np.asarray(a) for a in r_ext(
        rh.index, qp, rh.r, nbr=rh.nbr, rerank=False, metric=rh.metric))
    np.testing.assert_array_equal(rh.candidates_batch(hidden), r_ids)
    np.testing.assert_array_equal(leaves, r_leaves)
    assert_ties_only(ids, d, r_ids, r_d)
    assert ph.last_coverage == rh.last_coverage == 1.0


def test_step_batch_via_frontend_equals_step_batch(heads, hidden):
    """Decode rows submitted one by one through a coalescing front-end
    give exactly the batched step's tokens, and the same recall stats."""
    _, ph = heads
    with ph.make_frontend(max_batch=8, max_wait=0.2) as fe:
        before = ph.stats.tokens, ph.stats.exact_in_topr
        via = ph.step_batch_via(fe, hidden)
        via_stats = (ph.stats.tokens - before[0],
                     ph.stats.exact_in_topr - before[1])
    assert fe.stats.completed == len(hidden) and fe.stats.failed == 0
    before = ph.stats.tokens, ph.stats.exact_in_topr
    direct = ph.step_batch(hidden)
    np.testing.assert_array_equal(via, direct)
    assert via_stats == (ph.stats.tokens - before[0],
                         ph.stats.exact_in_topr - before[1])


def test_shard_health_api_and_degraded_coverage(heads, hidden):
    """The health API refuses what the reference refuses, and a degraded
    four-shard front-end reports the reference's coverage."""
    rh, ph = heads
    with pytest.raises(ValueError, match="entries"):
        ph.set_shard_health((True, True))         # 1-shard device index
    with pytest.raises(ValueError, match="every shard dead"):
        ph.set_shard_health((False,))
    ph.set_shard_health((True,))
    ph.candidates_batch(hidden[:2])
    assert ph.last_coverage == 1.0
    ph.set_shard_health(None)
    assert ph._shard_health is None
    health = (True, True, False, True)
    p_dev = ph.index.device_index(n_shards=4, device=CPU)
    r_dev = rh.index.device_index(n_shards=4)
    with ph.make_frontend(max_batch=4, max_wait=0.2, warm=False,
                          dev=p_dev.with_shard_health(health)) as fe:
        p_tok = ph.step_batch_via(fe, hidden[:4], track_exact=False)
    with rh.make_frontend(max_batch=4, max_wait=0.2, warm=False,
                          dev=r_dev.with_shard_health(health)) as fe:
        r_tok = rh.step_batch_via(fe, hidden[:4], track_exact=False)
    assert 0.0 < ph.last_coverage < 1.0
    assert ph.last_coverage == rh.last_coverage
    assert p_tok.shape == r_tok.shape == (4,)
