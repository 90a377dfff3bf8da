"""kNN-softmax approximation served through Dumpy (paper §1, application 3;
port of ``repro.serving.knn_softmax``).

Large-vocabulary decoding spends its time on the ``[d_model → vocab]`` logit
matmul.  The kNN-softmax trick [69] observes that softmax mass concentrates
on the output embeddings nearest the hidden state: retrieve the top-R
candidate tokens with an ANN index, compute exact logits only for them.  The
paper's own evaluation (kNN recall ≥ 80% → near-exact accuracy) is exactly
Dumpy's approximate-search operating point.

Dumpy indexes the *output embedding rows* (vocab vectors of length d_model,
z-normalized as data series); each decode step routes the hidden state and
runs extended approximate search (Alg. 4): the host ``extended_search``
for one state, ``extended_search_device_batch`` on the card for a batch.
The exact logits over the candidates and the token choice stay on the host
(numpy), as in the reference, so tokens compare bitwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.build import DumpyParams
from ..core.index import DumpyIndex
from ..core.metric import resolve
from ..core.sax import SaxParams
from ..core.search import extended_search
from ..core.search_device import extended_search_device_batch
from ..core.split import SplitParams


@dataclasses.dataclass
class KnnSoftmaxStats:
    tokens: int = 0
    exact_in_topr: int = 0          # retrieval recall numerator
    agree_argmax: int = 0           # approx argmax == exact argmax


class KnnSoftmaxHead:
    def __init__(self, lm_head: np.ndarray, *, w: int = 8, th: int = 256,
                 r_candidates: int = 512, nbr_nodes: int = 8,
                 metric: str = "ed", band: int | None = None,
                 device: str | torch.device = "cuda"):
        """``lm_head [d_model, vocab]`` — the output embedding matrix.
        The index's device layout lives on ``device`` (CUDA unless the
        caller asks for ``"cpu"``; raises where CUDA is absent).

        ``metric``/``band`` select the retrieval distance and thread through
        both the host and the batched device extended search.  The default
        (and the only choice for which the MIPS augmentation below is exact)
        is ED; ``"dtw"`` serves warping-invariant retrieval over
        series-valued rows (e.g. when the head indexes raw series rather
        than embeddings).

        Maximum-inner-product search reduces to Euclidean kNN by the standard
        augmentation: index ``x' = [x, sqrt(M^2 - |x|^2)]`` (all rows then
        share norm M) and query ``q' = [q, 0]`` — then
        ``argmin |q'-x'|^2 = argmax q·x`` exactly.  Rows are mean/scale
        standardized per-feature so the N(0,1) SAX breakpoints stay busy."""
        self.lm_head = np.asarray(lm_head, np.float32)
        vocab_vectors = self.lm_head.T                     # [vocab, d]
        norms2 = (vocab_vectors ** 2).sum(axis=1)
        m2 = norms2.max()
        aug = np.sqrt(np.maximum(m2 - norms2, 0.0))[:, None]
        rows = np.concatenate([vocab_vectors, aug], axis=1)
        # translation + *isotropic* scale preserve L2 neighbor order exactly
        self.mu = rows.mean(axis=0)
        self.sd = float(rows.std()) + 1e-6
        std = ((rows - self.mu) / self.sd).astype(np.float32)
        # zero-pad to a multiple of w (edge-replication would overweight the
        # augmented MIPS coordinate w-fold and distort distances)
        self.pad = (-std.shape[1]) % w
        series = np.pad(std, ((0, 0), (0, self.pad)))
        params = DumpyParams(sax=SaxParams(w=w, b=8),
                             split=SplitParams(th=th))
        self.index = DumpyIndex.build(series, params)
        # the serving path holds the device-resident layout, not raw arrays:
        # uploaded once here, reused by every decode step
        self.device = device
        self.device_index = self.index.device_index(device=device)
        self.w = w
        self.r = r_candidates
        self.nbr = nbr_nodes
        self.d_model = self.lm_head.shape[0]
        self.metric = resolve(metric, series.shape[1], band)
        self.stats = KnnSoftmaxStats()
        # degraded-mode serving state (docs/robustness.md): a health mask
        # applied to every batched retrieval, and the coverage of the last
        # batch (1.0 = every live vocab row was reachable)
        self._shard_health = None
        self.last_coverage = 1.0

    def set_shard_health(self, health) -> None:
        """Mark device shards dead/alive for subsequent batched retrievals
        (``None`` restores full health).  Dead shards' vocab rows drop out
        of the candidate sets; ``last_coverage`` reports the reachable
        fraction after each ``candidates_batch``."""
        # validate eagerly against the current device layout
        self.index.device_index(device=self.device).with_shard_health(health)
        self._shard_health = (None if health is None
                              else tuple(bool(h) for h in health))

    def _validate_hidden(self, H: np.ndarray) -> np.ndarray:
        """Host-boundary guard: a NaN/Inf hidden state would silently poison
        the retrieval top-k (NaN distances never beat any cutoff), and a
        wrong-width one would be augmented into nonsense."""
        H = np.asarray(H)
        if H.dtype.kind not in "fiu":
            raise TypeError(
                f"hidden states must be real-numeric, got dtype {H.dtype}")
        H = np.atleast_2d(H).astype(np.float32, copy=False)
        if H.ndim != 2 or H.shape[1] != self.d_model:
            raise ValueError(
                f"hidden states must be [B, d_model={self.d_model}], "
                f"got shape {H.shape}")
        if not np.isfinite(H).all():
            bad = np.where(~np.isfinite(H).all(axis=1))[0]
            raise ValueError(
                f"hidden states {bad[:8].tolist()} contain NaN/Inf values")
        return H

    def candidates(self, h: np.ndarray) -> np.ndarray:
        """Top-R candidate token ids for hidden state ``h [d_model]``."""
        h = self._validate_hidden(h)[0]
        q = np.concatenate([np.asarray(h, np.float32), [0.0]])
        q = (q - self.mu) / self.sd   # same isometry(+scale) as the index
        q = np.pad(q, (0, self.pad)).astype(np.float32)
        ids, _, _ = extended_search(self.index, q, self.r, self.nbr,
                                    metric=self.metric)
        return ids

    def logits_sparse(self, h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(candidate ids, exact logits over candidates)."""
        cand = self.candidates(h)
        return cand, h @ self.lm_head[:, cand]

    def step(self, h: np.ndarray, track_exact: bool = True) -> int:
        cand, logit_c = self.logits_sparse(h)
        tok = int(cand[int(np.argmax(logit_c))])
        if track_exact:
            full = h @ self.lm_head
            exact = int(np.argmax(full))
            self.stats.tokens += 1
            self.stats.exact_in_topr += int(exact in set(int(c) for c in cand))
            self.stats.agree_argmax += int(exact == tok)
        return tok

    # -- batched serving path (device-resident search) -----------------------

    def _encode_queries(self, H: np.ndarray) -> np.ndarray:
        """Apply the MIPS augmentation + index isometry to a batch of hidden
        states ``H [B, d_model]`` (validated at this host boundary)."""
        H = self._validate_hidden(H)
        q = np.concatenate([H, np.zeros((len(H), 1), np.float32)], axis=1)
        q = (q - self.mu) / self.sd
        return np.pad(q, ((0, 0), (0, self.pad))).astype(np.float32)

    def candidates_batch(self, H: np.ndarray,
                         nbr: int | None = None) -> np.ndarray:
        """Top-R candidate ids for a whole decode batch in one device program
        (vectorized root→subtree descent + LB-ordered sibling leaf schedule —
        the same Alg. 4 visit set as the host ``candidates`` path).  ``nbr``
        is the per-call recall/latency knob (default: the head's
        ``nbr_nodes``).  Candidate ids are deduped in the device merge and no
        host re-rank runs — the whole retrieval stays on device.  Returns
        ``[B, R] int64`` with -1 padding where a batch row found fewer."""
        # re-resolve through the index cache: a hit is a dict lookup (plus a
        # cheap tombstone-snapshot compare), so the device state uploads once
        # but deletions/inserts between decode steps are never served stale
        self.device_index = self.index.device_index(device=self.device)
        dev = self.device_index
        if self._shard_health is not None:
            dev = dev.with_shard_health(self._shard_health)
        res = extended_search_device_batch(
            self.index, self._encode_queries(H), self.r,
            nbr=(self.nbr if nbr is None else nbr),
            dev=dev, rerank=False, metric=self.metric)
        self.last_coverage = res[3] if len(res) > 3 else 1.0
        return res[0]

    def _select_tokens(self, H: np.ndarray, cand: np.ndarray,
                       track_exact: bool) -> np.ndarray:
        """Exact logits over the candidate ids + argmax token per row (the
        shared tail of :meth:`step_batch` and :meth:`step_batch_via`)."""
        logits = np.einsum("bd,dbr->br", H,
                           self.lm_head[:, np.maximum(cand, 0)])
        logits = np.where(cand >= 0, logits, -np.inf)
        toks = cand[np.arange(len(H)), np.argmax(logits, axis=1)]
        if track_exact:
            full = H @ self.lm_head                          # [B, vocab]
            exact = np.argmax(full, axis=1)
            self.stats.tokens += len(H)
            self.stats.exact_in_topr += int(
                ((cand == exact[:, None]) & (cand >= 0)).any(axis=1).sum())
            self.stats.agree_argmax += int((exact == toks).sum())
        return toks.astype(np.int64)

    def step_batch(self, H: np.ndarray, track_exact: bool = True,
                   nbr: int | None = None) -> np.ndarray:
        """Batched ``step``: one token id per row of ``H [B, d_model]``."""
        H = np.atleast_2d(np.asarray(H, np.float32))
        cand = self.candidates_batch(H, nbr=nbr)             # [B, R]
        return self._select_tokens(H, cand, track_exact)

    # -- continuous-batching serving path (docs/serving.md) -------------------

    def make_frontend(self, *, max_batch: int = 64, max_wait: float = 0.002,
                      **kw):
        """A request-coalescing :class:`~repro_torch.serving.batching.
        CoalescingFrontend` over this head's index: decode rows submit as
        single requests and coalesce (with any concurrent traffic) into
        bucketed device programs.  ``k_max`` defaults to the head's
        candidate width ``r`` and the head's metric/band/shard-health state
        and device thread through."""
        from .batching import CoalescingFrontend
        kw.setdefault("device", self.device)
        kw.setdefault("k_max", self.r)
        kw.setdefault("nbr_max", max(self.nbr, 8))
        if self.metric.is_dtw:
            kw.setdefault("band", self.metric.band)
        return CoalescingFrontend(self.index, max_batch=max_batch,
                                  max_wait=max_wait,
                                  shard_health=self._shard_health, **kw)

    def step_batch_via(self, frontend, H: np.ndarray,
                       track_exact: bool = True,
                       nbr: int | None = None) -> np.ndarray:
        """Batched decode step routed through a coalescing front-end.

        Hidden states validate **once** (the vectorized check inside
        :meth:`_encode_queries`) instead of once per row like the old
        ``serve.py`` host loop; each encoded row then submits as a single
        request, so independent decode streams sharing one front-end
        coalesce into common buckets.  Token selection and recall stats are
        those of :meth:`step_batch`."""
        H = np.atleast_2d(np.asarray(H, np.float32))
        qs = self._encode_queries(H)     # one vectorized validation per batch
        met = "dtw" if self.metric.is_dtw else "ed"
        futs = [frontend.submit(q, k=self.r,
                                nbr=(self.nbr if nbr is None else nbr),
                                metric=met) for q in qs]
        res = [f.result() for f in futs]
        self.last_coverage = min((r.coverage for r in res), default=1.0)
        cand = np.stack([r.ids for r in res])                # [B, R]
        return self._select_tokens(H, cand, track_exact)
