"""Registry of every entry point under audit, as (set-up, policy flags)
(port of ``repro.analysis.registry``).

Each :class:`Entry` names one program the reference audits, under the
reference's name, and knows how to run the port's public function for it at
fixed *audit shapes* on real data (``random_walks`` from a seed):

==========================  =============================================
``search_exact_ed``         ``exact_search_device_batch`` (ED)
``search_exact_dtw``        the same, DTW, order ``"shared"``
``search_exact_dtw_lane``   the same, DTW, order ``"cluster"``
``search_exact_ed_degraded``  ED on four shards, shard 3 dead
``search_extended``         ``extended_search_device_batch`` (re-ranked)
``search_approx``           ``approximate_search_device_batch``
``search_oneshot``          ``core.distributed.search_step``
``build_step``              ``core.distributed.build_step``
``build_bottomup``          ``core.build_device._lexsort_words``
``serving_head``            ``KnnSoftmaxHead.candidates_batch`` at
                            :data:`SERVING_SHAPES`
``serving_bucket``          ``bucket_search_launch``: a mixed-knob bucket
                            with DTW lanes and a dead lane
==========================  =============================================

The audit shapes (4 096 × 64, w=16, b=8, th=64: 160 leaves, height 4;
chunk 128: 32 spans; batch 8, k=10, nbr=4) are small enough for the whole
registry to run on the CPU in seconds and large enough for every loop to
run more than once (the span loop and the lane walk each pass two stop
tests, the descents take four levels, the scans four leaf ranks).  The set-up (index,
``DeviceIndex``, inputs on the device) runs before the census; what the
census sees is the call a user makes.

Flags: ``device_path`` forbids float64 results; ``sync_free`` forbids host
syncs (the one-shot programs and the bucket launch, which a front-end
queues without waiting); ``shape_fixed`` says the entry's loops follow its
shapes, not its data, so its kernel calls and syncs on the card must equal
the CPU's (the exact searches stop on their data: their counts are only
printed beside the CPU's); ``sharded=False`` forbids device moves.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import numpy as np

#: shared audit shapes (see the module docstring)
AUDIT_SHAPES = dict(n_series=4096, length=64, w=16, b=8, th=64, chunk=128)
AUDIT_K = 10
AUDIT_NBR = 4
AUDIT_Q_BATCH = 8
AUDIT_SEED = 0
#: the degraded entry's shards and their health
DEGRADED_HEALTH = (True, True, True, False)
#: the bucket entry's lanes: per-lane k / nbr / metric, lane 7 dead (k 0)
BUCKET_KS = (10, 5, 10, 1, 10, 3, 7, 0)
BUCKET_NBRS = (4, 1, 2, 3, 4, 2, 1, 0)
BUCKET_DTW = (False, True, False, False, True, False, False, False)

#: serving-head audit shapes: the reference's (vocab retrieval regime),
#: th=32 giving 541 leaves for its 512
SERVING_SHAPES = dict(vocab=1 << 14, d_model=128, w=16, n_leaves=512,
                      r_candidates=32, nbr=4, q_batch=8)
SERVING_TH = 32


@dataclass(frozen=True)
class Entry:
    """One entry point under audit.  ``setup(state)`` builds what the call
    needs and returns the call itself, a thunk the census runs."""
    name: str
    describe: str
    setup: Callable
    device_path: bool = True
    sync_free: bool = False
    shape_fixed: bool = False
    sharded: bool = True


class AuditState:
    """The audit's data, index and device inputs on one device, built on
    first use (an entry builds only what it reads)."""

    def __init__(self, device):
        from ..core.device_index import resolve_device
        from ..data.series import query_workload, random_walks
        self.device = resolve_device(device)
        s = AUDIT_SHAPES
        self.db = random_walks(s["n_series"], s["length"], seed=AUDIT_SEED)
        self.qs = query_workload(AUDIT_Q_BATCH, s["length"])

    def _up(self, a: np.ndarray):
        import torch
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @functools.cached_property
    def params(self):
        from ..core.build import DumpyParams
        from ..core.sax import SaxParams
        from ..core.split import SplitParams
        s = AUDIT_SHAPES
        return DumpyParams(sax=SaxParams(w=s["w"], b=s["b"]),
                           split=SplitParams(th=s["th"]))

    @functools.cached_property
    def index(self):
        from ..core.index import DumpyIndex
        return DumpyIndex.build(self.db, self.params)

    def dev(self, n_shards: int = 1):
        return self.index.device_index(chunk=AUDIT_SHAPES["chunk"],
                                       n_shards=n_shards, device=self.device)

    @functools.cached_property
    def qs_dev(self):
        return self._up(self.qs)

    @functools.cached_property
    def db_dev(self):
        return self._up(self.db)

    @functools.cached_property
    def sax_dev(self):
        from ..core.sax import sax_encode_np
        return self._up(sax_encode_np(self.db, self.params.sax)[1])

    @functools.cached_property
    def db_ordered_dev(self):
        return self._up(self.index.db_ordered)

    @functools.cached_property
    def head(self):
        from ..serving.knn_softmax import KnnSoftmaxHead
        s = SERVING_SHAPES
        rng = np.random.default_rng(AUDIT_SEED)
        lm_head = rng.standard_normal((s["d_model"], s["vocab"]),
                                      dtype=np.float32)
        return KnnSoftmaxHead(lm_head, w=s["w"], th=SERVING_TH,
                              r_candidates=s["r_candidates"],
                              nbr_nodes=s["nbr"], device=self.device)

    @functools.cached_property
    def hidden(self) -> np.ndarray:
        s = SERVING_SHAPES
        rng = np.random.default_rng(AUDIT_SEED + 1)
        return rng.standard_normal((s["q_batch"], s["d_model"]),
                                   dtype=np.float32)


def _exact(**kw):
    def setup(st: AuditState):
        from ..core import search_device as sd
        st.dev(kw.get("n_shards", 1))
        return lambda: sd.exact_search_device_batch(
            st.index, st.qs, AUDIT_K, chunk=AUDIT_SHAPES["chunk"],
            device=st.device, **kw)
    return setup


def _extended(st: AuditState):
    from ..core import search_device as sd
    st.dev()
    return lambda: sd.extended_search_device_batch(
        st.index, st.qs, AUDIT_K, nbr=AUDIT_NBR,
        chunk=AUDIT_SHAPES["chunk"], device=st.device)


def _approx(st: AuditState):
    from ..core import search_device as sd
    dev = st.dev()
    return lambda: sd.approximate_search_device_batch(
        st.index, st.qs, AUDIT_K, nbr=AUDIT_NBR, dev=dev)


def _oneshot(st: AuditState):
    from ..core.distributed import search_step
    dev = st.dev()
    args = (st.qs_dev, st.db_ordered_dev, dev.leaf_lo_g, dev.leaf_hi_g,
            AUDIT_K)
    return lambda: search_step(*args)


def _build_step(st: AuditState):
    from ..core.distributed import build_step
    db = st.db_dev
    return lambda: build_step(db, AUDIT_SHAPES["w"], AUDIT_SHAPES["b"])


def _bottomup(st: AuditState):
    from ..core.build_device import _lexsort_words
    sax = st.sax_dev
    return lambda: _lexsort_words(sax, AUDIT_SHAPES["w"], AUDIT_SHAPES["b"])


def _head(st: AuditState):
    head, hidden = st.head, st.hidden
    return lambda: head.candidates_batch(hidden)


def _bucket(st: AuditState):
    from ..core import search_device as sd
    dev, qs = st.dev(), st.qs_dev
    return lambda: sd.bucket_search_launch(
        st.index, qs, BUCKET_NBRS, BUCKET_DTW, k_max=AUDIT_K,
        nbr_max=AUDIT_NBR, dev=dev)


def _make_entries() -> tuple[Entry, ...]:
    return (
        Entry("search_exact_ed",
              "exact ED kNN: prune scan, span loop (stop test every 16 "
              "spans), dedup merge, host re-rank", _exact()),
        Entry("search_exact_dtw",
              "exact DTW kNN, shared span order (LB cascade + masked band "
              "DP in DTW_SUB sub-slabs)",
              _exact(metric="dtw", order="shared")),
        Entry("search_exact_dtw_lane",
              "exact DTW kNN, cluster lane order (LB tables, per-query "
              "sorted lanes, the lane walk)",
              _exact(metric="dtw", order="cluster")),
        Entry("search_exact_ed_degraded",
              "degraded exact ED kNN: four shards, shard 3 masked out of "
              "the merge", _exact(n_shards=4, shard_health=DEGRADED_HEALTH)),
        Entry("search_extended",
              "extended (Alg. 4) search: subtree descent, sibling "
              "schedule, leaf-rank scan, host re-rank", _extended,
              shape_fixed=True),
        Entry("search_approx",
              "batched approximate descent: root-to-leaf routing, leaf "
              "top-k over nbr ranks", _approx, shape_fixed=True),
        Entry("search_oneshot",
              "one-shot LB scan + exact distances over the whole ordered "
              "collection (search_step)", _oneshot, sync_free=True,
              shape_fixed=True),
        Entry("build_step",
              "build Stage 1 (SAX table) + root histogram of one shard",
              _build_step, sync_free=True, shape_fixed=True),
        Entry("build_bottomup",
              "bottom-up device build grouping: packed-word stable sorts + "
              "group delimiting (global, must stay on one device)",
              _bottomup, sync_free=True, shape_fixed=True, sharded=False),
        Entry("serving_head",
              "KnnSoftmaxHead retrieval: extended search at serving widths "
              "(rerank=False)", _head, shape_fixed=True),
        Entry("serving_bucket",
              "coalescing front-end bucket launch: extended search with "
              "per-lane nbr/metric knobs and a dead lane, queued without "
              "waiting", _bucket, sync_free=True, shape_fixed=True),
    )


_ENTRIES: tuple[Entry, ...] | None = None
_STATES: dict[str, AuditState] = {}


def entries(names=None) -> tuple[Entry, ...]:
    """All registered entries, or those named."""
    global _ENTRIES
    if _ENTRIES is None:
        _ENTRIES = _make_entries()
    if names is None:
        return _ENTRIES
    by_name = {e.name: e for e in _ENTRIES}
    unknown = [n for n in names if n not in by_name]
    if unknown:
        raise KeyError(f"unknown audit entries {unknown}; "
                       f"registered: {sorted(by_name)}")
    return tuple(by_name[n] for n in names)


def names() -> tuple[str, ...]:
    return tuple(e.name for e in entries())


def audit_state(device="cuda") -> AuditState:
    """The shared :class:`AuditState` of ``device`` (CUDA unless the caller
    asks for the CPU; raises where CUDA is absent)."""
    from ..core.device_index import resolve_device
    key = str(resolve_device(device))
    if key not in _STATES:
        _STATES[key] = AuditState(key)
    return _STATES[key]
