"""Brute-force exact kNN — ground truth for every benchmark and test (copy
of ``repro.core.baselines.brute``)."""
from __future__ import annotations

import numpy as np

from ..lb import dtw_np, ed_np


def brute_force_knn(db: np.ndarray, q: np.ndarray, k: int,
                    metric: str = "ed", band: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    if metric == "ed":
        d = ed_np(q, db)
    else:
        band = band or max(1, int(0.1 * db.shape[1]))
        d = np.array([dtw_np(q, x, band) for x in db])
    idx = np.argsort(d, kind="stable")[:k]
    return idx.astype(np.int64), d[idx].astype(np.float32)
