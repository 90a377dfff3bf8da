"""Request-coalescing serving front-end (continuous batching, docs/serving.md;
port of ``repro.serving.batching``).

The batched search entry points are closed-loop: fixed-size batches.
Serving is open-loop — single requests arrive on their own clock, each with
its own ``k``/``nbr``/``metric`` — while the device wants wide batches.
This module bridges the two:

* **coalescing** — requests queue until either a full ``max_batch`` is
  waiting or ``max_wait`` has elapsed since the *first* queued request (the
  deadline is per-bucket, so a lone request never waits longer than
  ``max_wait``);
* **bucketed shapes** — the coalesced set is padded up to the next
  power-of-two bucket (``bucket_ladder``), so the device meets exactly
  ``log2(max_batch) + 1`` batch shapes.  Per-request knobs ride as lane
  arrays through ``search_device.bucket_search_launch`` — masking absorbs
  the knob mix.  ``warmup`` runs the whole ladder up front (pure ED and
  with a DTW lane), which builds the kernels and leaves the caching
  allocator holding the pool every bucket needs;
* **overlapped transfer** — the dispatcher launches bucket *i* (the launch
  only queues work on the stream and returns), then collects, validates
  and stages bucket *i+1* while *i* computes, and only then waits for
  *i*'s results.  Staging pads into one of two pinned host buffers per
  bucket size and copies it non-blocking on the compute stream; a buffer
  is refilled only after its last queued copy has run;
* **per-batch validation** — submit runs only the O(1) structural checks;
  the NaN/Inf scan is one vectorized pass per coalesced bucket, and a bad
  lane fails *its own* future with the exact error an individual call would
  have raised (``lane_finite_error``) while the rest of the bucket proceeds;
* **graceful shutdown** — ``close()`` stops intake, drains the queue
  (flushing partial buckets immediately, no deadline wait), and completes
  every outstanding future.  The ``serving.enqueue`` / ``serving.flush``
  failpoints (``repro_torch.robustness.failpoints``) inject faults at the
  two boundaries: a flaky flush is retried transparently; an exhausted one
  fails only that bucket's futures and the front-end keeps serving.

Every device call runs on the dispatcher thread, except ``warmup``, which
runs before the thread starts.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from ..core import search_device as sd
from ..core.index import DumpyIndex
from ..robustness.failpoints import (FailpointError, RetriesExhausted,
                                     failpoint, with_retries)


def bucket_ladder(max_batch: int) -> tuple[int, ...]:
    """Power-of-two bucket sizes ``1, 2, 4, …, max_batch`` (``max_batch``
    is rounded up to a power of two)."""
    top = 1
    while top < max(int(max_batch), 1):
        top *= 2
    sizes, b = [], 1
    while b <= top:
        sizes.append(b)
        b *= 2
    return tuple(sizes)


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """One request's answer: ``ids``/``d`` are the lane's own ``k`` columns
    (``-1 / inf`` padded when the index holds fewer), ``leaves`` its visit
    schedule, ``coverage`` the reachable live fraction at harvest time
    (1.0 when every shard is healthy), ``t_done`` the ``perf_counter``
    completion stamp (open-loop latency = ``t_done - scheduled arrival``)."""
    ids: np.ndarray
    d: np.ndarray
    leaves: np.ndarray
    coverage: float
    t_done: float


@dataclasses.dataclass
class ServingStats:
    """Aggregate front-end counters (see docs/serving.md for how a load
    generator reads them)."""
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    batches: int = 0
    lanes: int = 0         # dispatched lanes: sum of bucket widths
    live_lanes: int = 0    # lanes that carried a real request
    occupancy: dict = dataclasses.field(default_factory=dict)

    @property
    def padding_waste(self) -> float:
        """Fraction of dispatched lanes that were padding."""
        return 1.0 - self.live_lanes / self.lanes if self.lanes else 0.0

    @property
    def mean_occupancy(self) -> float:
        return self.live_lanes / self.batches if self.batches else 0.0

    def snapshot(self) -> dict:
        return {"submitted": self.submitted, "completed": self.completed,
                "failed": self.failed, "batches": self.batches,
                "lanes": self.lanes, "live_lanes": self.live_lanes,
                "padding_waste": round(self.padding_waste, 4),
                "mean_occupancy": round(self.mean_occupancy, 3),
                "occupancy": {str(k): v
                              for k, v in sorted(self.occupancy.items())}}


class _Request:
    __slots__ = ("q", "k", "nbr", "dtw", "t_arrival", "fut")

    def __init__(self, q, k, nbr, dtw, t_arrival, fut):
        self.q, self.k, self.nbr, self.dtw = q, k, nbr, dtw
        self.t_arrival, self.fut = t_arrival, fut


class _Staged:
    """One padded bucket, validated, its queries copied (or queued to copy)
    to the device."""
    __slots__ = ("reqs", "qs_dev", "lane_k", "lane_nbr", "lane_dtw")

    def __init__(self, reqs, qs_dev, lane_k, lane_nbr, lane_dtw):
        self.reqs = reqs              # [B] _Request | None (padding/failed)
        self.qs_dev = qs_dev
        self.lane_k, self.lane_nbr, self.lane_dtw = lane_k, lane_nbr, lane_dtw


class CoalescingFrontend:
    """Async single-request front-end over a :class:`DumpyIndex` (module
    docstring).  Construction warms the bucket ladder and starts the
    dispatcher thread; use as a context manager or call :meth:`close`.

    ``k_max``/``nbr_max`` bound the per-request knobs (they fix the bucket
    program's widths); ``max_wait`` is the coalescing deadline in seconds;
    ``shard_health`` serves degraded (docs/robustness.md).  The front-end
    serves ``dev``, or else the index's cached layout on ``device`` (CUDA
    unless the caller asks for ``"cpu"``; raises where CUDA is absent)."""

    def __init__(self, index: DumpyIndex, *, k_max: int = 32,
                 nbr_max: int = 8, max_batch: int = 64,
                 max_wait: float = 0.002, band: int | None = None,
                 dev=None, shard_health=None, warm: bool = True,
                 device: str | torch.device = "cuda"):
        self.index = index
        self.n = int(index.n)
        self.k_max = int(k_max)
        self.nbr_max = int(nbr_max)
        self.buckets = bucket_ladder(max_batch)
        self.max_batch = self.buckets[-1]
        self.max_wait = float(max_wait)
        self.band = band
        self._dev = dev if dev is not None else index.device_index(
            device=device)
        if shard_health is not None:
            self._dev = self._dev.with_shard_health(shard_health)
        self._device = self._dev.device
        # two host staging buffers per bucket size (pinned on CUDA), each
        # with the event of its last queued copy; used in turn
        self._bufs: dict[int, list] = {}
        self._turn: dict[int, int] = {}
        self._lock = threading.Condition()
        self._queue: collections.deque[_Request] = collections.deque()
        self._closing = False
        self._failed: BaseException | None = None
        self.stats = ServingStats()
        self._thread: threading.Thread | None = None
        if warm:
            self.warmup()
        self.start()

    # -- lifecycle -----------------------------------------------------------

    def warmup(self) -> None:
        """Run the whole bucket ladder before serving, twice per bucket
        size: pure ED, and with a DTW lane (the two variants of the bucket
        program, ``has_dtw``), then wait for the device.  That builds the
        kernels, leaves the caching allocator holding every bucket's pool,
        uploads the degraded-mode shard mask, and allocates the staging
        buffers — so the first request pays none of it."""
        for B in self.buckets:
            self._buffers(B)
            qs = torch.zeros((B, self.n), dtype=torch.float32,
                             device=self._device)
            lane_nbr = np.minimum(np.arange(B) + 1, self.nbr_max)
            for dtw_tail in (False, True):
                lane_dtw = np.zeros(B, bool)
                lane_dtw[B - 1] = dtw_tail
                sd.bucket_search_launch(
                    self.index, qs, lane_nbr, lane_dtw, k_max=self.k_max,
                    nbr_max=self.nbr_max, band=self.band, dev=self._dev)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop,
                                            name="coalescing-frontend",
                                            daemon=True)
            self._thread.start()

    def close(self, timeout: float | None = None) -> None:
        """Graceful shutdown: stop intake, drain the queue (partial buckets
        flush immediately — no deadline wait), complete every outstanding
        future, stop the dispatcher."""
        with self._lock:
            self._closing = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self) -> "CoalescingFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- intake --------------------------------------------------------------

    def submit(self, query, k: int = 10, nbr: int = 4,
               metric: str = "ed") -> Future:
        """Enqueue one request → a Future of :class:`SearchResult`.

        Only O(1) structural validation runs here (dtype/shape/length and
        knob bounds — the same error types and messages as the batched entry
        points); the O(n) NaN/Inf scan is vectorized per coalesced bucket,
        and a bad query fails only its own future."""
        failpoint("serving.enqueue")
        if self._failed is not None:
            raise RuntimeError(
                "CoalescingFrontend dispatcher died") from self._failed
        if self._closing:
            raise RuntimeError("CoalescingFrontend is closed")
        q = sd._validate_queries_struct(query, self.n)
        if q.shape[0] != 1:
            raise ValueError(
                f"submit takes a single query [n], got shape "
                f"{np.asarray(query).shape}")
        k, nbr = int(k), int(nbr)
        if not 1 <= k <= self.k_max:
            raise ValueError(f"k={k} outside [1, k_max={self.k_max}]")
        if not 1 <= nbr <= self.nbr_max:
            raise ValueError(f"nbr={nbr} outside [1, nbr_max={self.nbr_max}]")
        if metric not in ("ed", "dtw"):
            raise ValueError(f"unknown metric {metric!r}")
        fut: Future = Future()
        req = _Request(q[0], k, nbr, metric == "dtw",
                       time.perf_counter(), fut)
        with self._lock:
            if self._closing:
                raise RuntimeError("CoalescingFrontend is closed")
            if self._failed is not None:
                raise RuntimeError(
                    "CoalescingFrontend dispatcher died") from self._failed
            self._queue.append(req)
            self.stats.submitted += 1
            self._lock.notify()
        return fut

    # -- dispatcher ----------------------------------------------------------

    def _collect(self, patience: float | None) -> list[_Request] | None:
        """Coalesce the next bucket.  ``patience=None`` blocks until traffic
        (or close); a finite ``patience`` — used while a launched bucket is
        still in flight — returns ``[]`` after that long with no arrivals,
        so the dispatcher can harvest the in-flight bucket instead of
        leaving its futures pending behind an idle queue.  Returns ``None``
        only when closing with the queue fully drained."""
        with self._lock:
            if patience is None:
                while not self._queue and not self._closing:
                    self._lock.wait()
            else:
                # lint: allow-timing: deadlines on the host clock, no window
                give_up = time.perf_counter() + patience
                while not self._queue and not self._closing:
                    rem = give_up - time.perf_counter()
                    if rem <= 0:
                        return []
                    self._lock.wait(timeout=rem)
            if not self._queue:
                return None if self._closing else []
            batch = [self._queue.popleft()]
            deadline = batch[0].t_arrival + self.max_wait
            while len(batch) < self.max_batch:
                if self._queue:
                    batch.append(self._queue.popleft())
                    continue
                if self._closing:
                    break
                rem = deadline - time.perf_counter()
                if rem <= 0:
                    break
                self._lock.wait(timeout=rem)
                if not self._queue and time.perf_counter() >= deadline:
                    break
            return batch

    def _buffers(self, B: int) -> list:
        """The two ``[buffer, event]`` staging slots of bucket size ``B``
        (allocated on first use; pinned host memory on CUDA)."""
        bufs = self._bufs.get(B)
        if bufs is None:
            pin = self._device.type == "cuda"
            bufs = [[torch.empty((B, self.n), dtype=torch.float32,
                                 pin_memory=pin), None] for _ in range(2)]
            self._bufs[B] = bufs
            self._turn[B] = 0
        return bufs

    def _stage(self, batch: list[_Request]) -> _Staged:
        """Pad to the bucket size in the bucket size's next staging buffer,
        run the one vectorized finite check, and queue the copy to the
        device without waiting (it overlaps the in-flight bucket's
        compute).  A lane failing the check gets the exact individual-path
        error on its future and dispatches dead (``nbr=0``) — the rest of
        the bucket is unaffected."""
        B = next(b for b in self.buckets if b >= len(batch))
        slot = self._buffers(B)[self._turn[B]]
        self._turn[B] ^= 1
        if slot[1] is not None:
            slot[1].synchronize()     # its last copy has run (long ago)
        qs = slot[0].numpy()
        for i, r in enumerate(batch):
            qs[i] = r.q
        qs[len(batch):] = 0.0
        bad = sd.lane_finite_mask(qs)               # zero pads are finite
        lane_k = np.zeros(B, np.int64)
        lane_nbr = np.zeros(B, np.int64)
        lane_dtw = np.zeros(B, bool)
        reqs: list[_Request | None] = [None] * B
        for i, r in enumerate(batch):
            if bad[i]:
                qs[i] = 0.0
                r.fut.set_exception(sd.lane_finite_error())
                self.stats.failed += 1
            else:
                reqs[i] = r
                lane_k[i] = r.k
                lane_nbr[i] = r.nbr
                lane_dtw[i] = r.dtw
        qs_dev = slot[0].to(self._device, non_blocking=True, copy=True)
        if self._device.type == "cuda":
            slot[1] = torch.cuda.Event()
            slot[1].record()
        return _Staged(reqs, qs_dev, lane_k, lane_nbr, lane_dtw)

    def _flush(self, staged: _Staged):
        """Launch the bucket program — it only queues work on the stream and
        returns before the compute finishes.  A flaky ``serving.flush``
        failpoint is retried transparently; exhaustion fails only this
        bucket's lanes and the front-end keeps serving."""
        live = [r for r in staged.reqs if r is not None]
        B = len(staged.reqs)
        self.stats.batches += 1
        self.stats.lanes += B
        self.stats.live_lanes += len(live)
        self.stats.occupancy[B] = self.stats.occupancy.get(B, 0) + 1
        if not live:
            return None

        def _go():
            failpoint("serving.flush")
            return sd.bucket_search_launch(
                self.index, staged.qs_dev, staged.lane_nbr, staged.lane_dtw,
                k_max=self.k_max, nbr_max=self.nbr_max, band=self.band,
                dev=self._dev)

        try:
            res = with_retries(_go, site="serving.flush")
        except (FailpointError, RetriesExhausted) as e:
            for r in live:
                r.fut.set_exception(e)
            self.stats.failed += len(live)
            return None
        return res

    def _harvest(self, staged: _Staged, res) -> None:
        """Wait for a launched bucket (the one device→host copy of
        ``bucket_search_finish``) and complete its futures."""
        ids, d, leaves = sd.bucket_search_finish(
            res, staged.lane_k, staged.lane_nbr, k_max=self.k_max)
        cov = sd.shard_coverage(self.index, self._dev)
        t_done = time.perf_counter()
        for i, r in enumerate(staged.reqs):
            if r is None:
                continue
            r.fut.set_result(SearchResult(
                ids=ids[i, :r.k], d=d[i, :r.k], leaves=leaves[i, :r.nbr],
                coverage=cov, t_done=t_done))
            self.stats.completed += 1

    def _loop(self) -> None:
        pending: tuple[_Staged, tuple] | None = None
        batch: list[_Request] | None = None
        staged: _Staged | None = None
        try:
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            while True:
                batch = self._collect(
                    self.max_wait if pending is not None else None)
                if batch is None:
                    break
                if not batch:                   # idle queue: drain in-flight
                    self._harvest(*pending)
                    pending = None
                    continue
                staged = self._stage(batch)     # overlaps in-flight compute
                batch = None
                if pending is not None:
                    self._harvest(*pending)     # wait for bucket i …
                    pending = None
                res = self._flush(staged)       # … then launch bucket i+1
                pending = (staged, res) if res is not None else None
                staged = None
            if pending is not None:
                self._harvest(*pending)
        except BaseException as e:              # InjectedCrash is BaseException
            with self._lock:
                self._failed = e
                self._closing = True
                orphans = list(self._queue)
                self._queue.clear()
                self._lock.notify_all()
            # every bucket the crash may have stranded: staged-but-unlaunched,
            # launched-but-unharvested, collected-but-unstaged, still queued
            for held in (staged, pending[0] if pending is not None else None):
                if held is not None:
                    orphans = [r for r in held.reqs if r is not None] \
                        + orphans
            if batch is not None:
                orphans = list(batch) + orphans
            err = RuntimeError("CoalescingFrontend dispatcher died")
            err.__cause__ = e
            for r in orphans:
                if not r.fut.done():
                    r.fut.set_exception(err)
                    self.stats.failed += 1
