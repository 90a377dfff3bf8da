"""Data-series generation and preparation (paper §7 [Datasets]) — copy of
``repro.data.series``.

``random_walks`` reproduces the paper's synthetic *Rand* dataset: cumulative
sums of N(0,1) steps, z-normalized.  Query workloads are drawn from the same
process but excluded from the collection (paper: 200 held-out queries).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the generators' rows a chunk, and the threads that finish chunks while
# the next one is drawn
CHUNK_ROWS, WORKERS = 1 << 16, 3


def z_normalize(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    mu = x.mean(axis=-1, keepdims=True)
    sd = x.std(axis=-1, keepdims=True)
    return ((x - mu) / np.maximum(sd, eps)).astype(np.float32)


def random_walks(n_series: int, length: int, seed: int = 0) -> np.ndarray:
    """The paper's Rand generator: z-normalized Gaussian random walks,
    bitwise ``repro.data.series.random_walks`` (made by ``_in_chunks``)."""
    rng = np.random.default_rng(seed)
    return _in_chunks(
        n_series, length,
        lambda m: rng.standard_normal((m, length), dtype=np.float32),
        lambda r0, r1, steps: z_normalize(np.cumsum(steps, axis=-1)))


def _in_chunks(n_series: int, length: int, draw, finish) -> np.ndarray:
    """A generator's ``[n_series, length]`` float32 rows, ``CHUNK_ROWS`` at
    a time: ``draw(m)`` takes the next ``m`` rows' random numbers from one
    stream, in this thread, so the draws are those of one whole-array call;
    ``finish(r0, r1, z)`` makes rows ``r0:r1`` from them, row by row, in a
    worker while the next chunk is drawn.  No whole-array temporary is
    held: the peak is the result plus a few chunks'."""
    out = np.empty((n_series, length), np.float32)

    def run(r0: int, r1: int, z: np.ndarray) -> None:
        out[r0:r1] = finish(r0, r1, z)

    with ThreadPoolExecutor(max_workers=WORKERS) as pool:
        pending: list = []
        for r0 in range(0, n_series, CHUNK_ROWS):
            r1 = min(r0 + CHUNK_ROWS, n_series)
            pending.append(pool.submit(run, r0, r1, draw(r1 - r0)))
            if len(pending) > WORKERS:
                pending.pop(0).result()
        for f in pending:
            f.result()
    return out


def query_workload(n_queries: int, length: int, seed: int = 10_007) -> np.ndarray:
    """Held-out queries (disjoint seed stream from the collection)."""
    return random_walks(n_queries, length, seed=seed)


def clustered_series(n_series: int, length: int, n_clusters: int = 32,
                     noise: float = 0.25, seed: int = 1) -> np.ndarray:
    """Skewed synthetic collection (dense + sparse regions — the §5.1 node
    imbalance regime): random-walk cluster centroids + Gaussian perturbation.

    Bitwise ``repro.data.series.clustered_series``, made by
    ``_in_chunks``: the assignment is drawn first, then the noise, one
    float64 chunk at a time, and every later step works row by row.
    """
    rng = np.random.default_rng(seed)
    centroids = random_walks(n_clusters, length, seed=seed + 1)
    assign = _assignment(rng, n_series, n_clusters)
    return _in_chunks(
        n_series, length, lambda m: rng.standard_normal((m, length)),
        lambda r0, r1, z: z_normalize(centroids[assign[r0:r1]]
                                      + noise * z.astype(np.float32)))


def cluster_assignment(n_series: int, n_clusters: int = 32,
                       seed: int = 1) -> np.ndarray:
    """The cluster of each series of ``clustered_series(n_series, ...,
    n_clusters=n_clusters, seed=seed)``: that generator's first draw."""
    return _assignment(np.random.default_rng(seed), n_series, n_clusters)


def _assignment(rng: np.random.Generator, n_series: int,
                n_clusters: int) -> np.ndarray:
    # zipf-ish skewed assignment
    p = 1.0 / np.arange(1, n_clusters + 1)
    p /= p.sum()
    return rng.choice(n_clusters, size=n_series, p=p)


def pad_to_multiple(x: np.ndarray, w: int) -> np.ndarray:
    """Right-pad series with their last value so that ``n % w == 0``."""
    n = x.shape[-1]
    rem = (-n) % w
    if rem == 0:
        return x
    pad = np.repeat(x[..., -1:], rem, axis=-1)
    return np.concatenate([x, pad], axis=-1)
