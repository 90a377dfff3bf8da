"""Data-series generation and preparation (paper §7 [Datasets]) — copy of
``repro.data.series``.

``random_walks`` reproduces the paper's synthetic *Rand* dataset: cumulative
sums of N(0,1) steps, z-normalized.  Query workloads are drawn from the same
process but excluded from the collection (paper: 200 held-out queries).
"""
from __future__ import annotations

import numpy as np


def z_normalize(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    mu = x.mean(axis=-1, keepdims=True)
    sd = x.std(axis=-1, keepdims=True)
    return ((x - mu) / np.maximum(sd, eps)).astype(np.float32)


def random_walks(n_series: int, length: int, seed: int = 0) -> np.ndarray:
    """The paper's Rand generator: z-normalized Gaussian random walks."""
    rng = np.random.default_rng(seed)
    steps = rng.standard_normal((n_series, length), dtype=np.float32)
    return z_normalize(np.cumsum(steps, axis=-1))


def query_workload(n_queries: int, length: int, seed: int = 10_007) -> np.ndarray:
    """Held-out queries (disjoint seed stream from the collection)."""
    return random_walks(n_queries, length, seed=seed)


def pad_to_multiple(x: np.ndarray, w: int) -> np.ndarray:
    """Right-pad series with their last value so that ``n % w == 0``."""
    n = x.shape[-1]
    rem = (-n) % w
    if rem == 0:
        return x
    pad = np.repeat(x[..., -1:], rem, axis=-1)
    return np.concatenate([x, pad], axis=-1)
