"""Recall@10 of the port's extended search against the reference's, at
the batch-search bench's shapes and parameters (``benchmarks/common.py``:
w=16, b=8, th=256, alpha 0.2; batch 64, ``rerank=False``, nbr 1, 4 and
16; ``benchmarks/bench_batch_search.py``'s data and query seeds), on the
CPU (``device="cpu"``).  Leaves bitwise, ids and distances by the rtol 1e-5
tie rule (``assert_ties_only``), recall exactly equal to the reference's
and to the committed ``BENCH_batch_search.json``."""
import numpy as np
import pytest

from _torch_port import (assert_ties_only, build_pair,
                         torch_threads)  # noqa: F401
from repro.core.baselines.brute import brute_force_knn
from repro.core.search_device import extended_search_device_batch as r_ext
from repro.data.series import random_walks
from repro_torch.core.search_device import (exact_search_device_batch,
                                            extended_search_device_batch)

CPU = "cpu"
K = 10
BAND = 6


def _recall(ids, gt):
    return float(np.mean([len(gt[i] & set(ids[i][ids[i] >= 0].tolist())) / K
                          for i in range(len(gt))]))


@pytest.mark.parametrize("metric", ["ed", "dtw"])
def test_recall_at_bench_shapes_equals_reference(metric):
    """recall@10 of extended search (``rerank=False``, nbr 1, 4, 16) at the
    batch-search bench's shapes and parameters (w=16, b=8, th=256, alpha
    0.2; batch 64): ED on ``random_walks(20000, 128)``, DTW on
    ``random_walks(4000, 64)`` with band 6.  The ground truth is a brute
    force for ED and the port's exact DTW search for DTW.  The port's
    recall equals the reference's computed here, and both equal the
    committed bench record."""
    if metric == "ed":
        db, qs = random_walks(20000, 128, seed=0), random_walks(64, 128,
                                                                seed=9064)
        gt = [set(brute_force_knn(db, q, K)[0].tolist()) for q in qs]
        bench = (0.2453125, 0.4359375, 0.85)
    else:
        db, qs = random_walks(4000, 64, seed=0), random_walks(64, 64,
                                                              seed=9164)
        bench = (0.2484375, 0.4546875, 0.6890625)
    ri, pi = build_pair(db, w=16, th=256)
    if metric == "dtw":
        ids, _, _ = exact_search_device_batch(pi, qs, K, metric="dtw",
                                              band=BAND, device=CPU)
        gt = [set(row.tolist()) for row in ids]
    for nbr, want in zip((1, 4, 16), bench):
        ids, d, leaves = extended_search_device_batch(
            pi, qs, K, nbr=nbr, rerank=False, metric=metric, band=BAND,
            device=CPU)
        r_ids, r_d, r_leaves = r_ext(ri, qs, K, nbr=nbr, rerank=False,
                                     metric=metric, band=BAND)
        np.testing.assert_array_equal(leaves, r_leaves)
        assert_ties_only(ids, d, r_ids, r_d)
        assert _recall(ids, gt) == _recall(r_ids, gt) == \
            pytest.approx(want, abs=1e-12)
