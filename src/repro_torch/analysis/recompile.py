"""The steady-state sweep (port of ``repro.analysis.recompile``).

The reference counts XLA compiles: its serving story holds only if every
program compiles at index load, not per request, so the cache key of a
bucket program is its batch shape plus ``has_dtw``, never a knob value.
Eager PyTorch compiles nothing; what a warm call must not repeat is
everything else a cold call paid for, and what a bucket shape must fix is
its sequence of launches — the precondition of capturing it once as a CUDA
graph.  :func:`run_sweep` drives the public batched entry points across the
reference's k × nbr × metric × batch grid and its serving bucket ladder
(1, 2, 4, 8 lanes: per-lane k / nbr / metric rotated, a dead padding lane)
**twice**, each call under a :class:`~repro_torch.analysis.contracts.Census`,
with the kernel library and the ``DeviceIndex`` built before the count.
Steady state means:

* pass 2 builds and loads no kernel library (``kernels._build.build``) and
  builds no ``DeviceIndex`` (``from_index`` / ``from_arrays``);
* every combination's kernel calls, aten ops (histogram and ordered
  sequence) and host syncs in pass 2 equal pass 1's, and its syncs stay
  within :func:`sync_budget` — the boundary transfers plus one stop test
  every ``STOP_CHECK_EVERY`` loop steps, so a per-step host read blows it;
* for one bucket shape (lanes and ``has_dtw``), every knob rotation gives
  the same ordered kernel-call and aten-op sequence inside
  ``bucket_search_launch``, and that launch makes no host sync.

``verify_sweep`` raises :class:`RecompileViolation` on any breach; the gate
tests substitute misbehaving wrappers to prove it trips.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

#: syncs at the host boundary a combination may pay besides its stop tests:
#: one upload of the queries and up to three result downloads
BOUNDARY_SYNCS = 4
#: the bucket ladder's knob rotations within one metric mix
ROTATIONS = 2
#: the layout's span width: several spans, so the span loop's stop test runs
SWEEP_CHUNK = 256


class RecompileViolation(AssertionError):
    """A warm call did not repeat its cold call, or a bucket's launches
    followed a knob."""


@dataclass(frozen=True)
class Combo:
    """One call of the sweep and what its census saw."""
    key: tuple
    kernel_calls: dict
    kernel_sequence: str
    aten_ops: dict
    aten_sequence: str
    host_syncs: dict
    budget: int | None = None
    group: tuple | None = None      # a bucket's (lanes, has_dtw)
    launch: dict | None = None      # the census of bucket_search_launch


@dataclass(frozen=True)
class SweepReport:
    passes: tuple[tuple[Combo, ...], tuple[Combo, ...]]
    builds: tuple[int, int]         # DeviceIndex builds per pass
    loads: tuple[int, int]          # kernel library builds per pass

    @property
    def violations(self) -> list[str]:
        return _violations(self)

    @property
    def combos(self) -> int:
        return len(self.passes[0])

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def launch_syncs(self) -> int:
        return sum(sum(c.launch["host_syncs"].values())
                   for p in self.passes for c in p if c.launch)


def _default_index(n: int = 2048, length: int = 64):
    from ..core.build import DumpyParams
    from ..core.index import DumpyIndex
    from ..core.sax import SaxParams
    from ..core.split import SplitParams
    from ..data.series import random_walks

    db = random_walks(n, length, seed=7)
    p = DumpyParams(sax=SaxParams(w=8, b=8), split=SplitParams(th=128))
    return DumpyIndex.build(db, p)


def sync_budget(kind: str, dev, *, q: int, k: int, metric: str) -> int:
    """The host syncs one sweep call may make: :data:`BOUNDARY_SYNCS` plus,
    for an exact search, the stop tests of its loops (the span loop: one
    schedule download and one test every ``STOP_CHECK_EVERY`` spans a
    shard; the DTW lane walk: one test every ``STOP_CHECK_EVERY`` chunks a
    group and shard)."""
    from ..core import search_device as sd
    if kind != "exact":
        return BOUNDARY_SYNCS
    S = dev.n_shards
    if metric != "dtw":
        W = dev.win_start[0].shape[0]
        return BOUNDARY_SYNCS + S * (1 + math.ceil(W / sd.STOP_CHECK_EVERY))
    Tp = dev.shard_rows
    kseed = min(sd._result_margin(dev, k) + 8, Tp)
    C = min(sd.DTW_LANE_CHUNK, Tp)
    NC = max(-(-(Tp - kseed) // C), 0)
    return BOUNDARY_SYNCS + S * sd._cluster_groups(q) * math.ceil(
        NC / sd.STOP_CHECK_EVERY)


class _Counting:
    """Count DeviceIndex builds and kernel-library builds while active."""

    def __enter__(self):
        from ..core.device_index import DeviceIndex
        from ..kernels import _build
        self.builds = self.loads = self._inside = 0
        self._undo = [(DeviceIndex, "from_index",
                       DeviceIndex.__dict__["from_index"]),
                      (DeviceIndex, "from_arrays",
                       DeviceIndex.__dict__["from_arrays"]),
                      (_build, "build", _build.build)]

        def counted(attr, fn):
            def call(*a, **kw):
                if attr == "build":
                    self.loads += 1
                elif not self._inside:      # from_index calls from_arrays
                    self.builds += 1
                self._inside += attr != "build"
                try:
                    return fn(*a, **kw)
                finally:
                    self._inside -= attr != "build"
            return call

        for owner, attr, orig in self._undo:
            fn = orig.__func__ if isinstance(orig, classmethod) else orig
            new = counted(attr, fn)
            setattr(owner, attr,
                    classmethod(new) if isinstance(orig, classmethod)
                    else new)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in self._undo:
            setattr(owner, attr, orig)


def run_sweep(index=None, *, ks=(5, 10), nbrs=(2, 4), metrics=("ed", "dtw"),
              batches=(4, 8), buckets=(1, 2, 4, 8), device="cuda", exact_fn=None, extended_fn=None,
              bucket_fn=None) -> SweepReport:
    """Run the k/nbr/metric/batch sweep and the bucket ladder twice, each
    call under a census (see the module docstring).

    ``exact_fn`` / ``extended_fn`` / ``bucket_fn`` default to the public
    batched entry points (called with ``chunk=`` and ``device=``); tests
    substitute misbehaving wrappers to prove the gate trips."""
    from ..core import search_device as sd
    from ..core.device_index import resolve_device
    from ..data.series import query_workload
    from .contracts import Census, _digest

    device = resolve_device(device)
    if index is None:
        index = _default_index()
    exact_fn = exact_fn or sd.exact_search_device_batch
    extended_fn = extended_fn or sd.extended_search_device_batch
    bucket_fn = bucket_fn or sd.bucket_search_device_batch
    if device.type == "cuda":
        from ..kernels import _build
        _build.lib()                    # the kernels build before the count
    dev = index.device_index(chunk=SWEEP_CHUNK, device=device)

    length = index.db.shape[1]
    qs = query_workload(max((*batches, *buckets), default=8), length)
    k_hi, nbr_hi = max(ks), max(nbrs)
    kw = dict(chunk=SWEEP_CHUNK, device=device)

    def censused(key, fn, *, budget=None, group=None, launches=None):
        with Census(device) as c:
            fn()
        launch = None
        if launches is not None:
            if len(launches) != 1:
                raise RecompileViolation(
                    f"{key}: bucket_search_launch ran {len(launches)} times "
                    f"in one bucket call")
            launch = launches.pop()
        return Combo(key, dict(c.kernel_calls), _digest(c.kernel_seq),
                     dict(c.aten_ops), _digest(c.aten_seq),
                     dict(c.host_syncs), budget, group, launch)

    def bucket_call(lane_k, lane_nbr, lane_m, launches):
        orig = sd.bucket_search_launch

        def launch(*a, **kwa):
            with Census(device) as c:
                out = orig(*a, **kwa)
            launches.append({"kernel_sequence": _digest(c.kernel_seq),
                             "aten_sequence": _digest(c.aten_seq),
                             "host_syncs": dict(c.host_syncs)})
            return out

        sd.bucket_search_launch = launch
        try:
            bucket_fn(index, qs[:len(lane_k)], lane_k, lane_nbr, lane_m,
                      k_max=k_hi, nbr_max=nbr_hi, **kw)
        finally:
            sd.bucket_search_launch = orig

    def one_pass() -> list[Combo]:
        out = []
        for met in metrics:
            for k in ks:
                for b in batches:
                    out.append(censused(
                        ("exact", met, k, b),
                        lambda: exact_fn(index, qs[:b], k, metric=met, **kw),
                        budget=sync_budget("exact", dev, q=b, k=k,
                                           metric=met)))
            for nbr in nbrs:
                out.append(censused(
                    ("extended", met, nbr),
                    lambda: extended_fn(index, qs[:max(batches)], k_hi,
                                        nbr=nbr, metric=met, **kw),
                    budget=BOUNDARY_SYNCS))
        for j, met in enumerate(metrics):
            for B in buckets:
                for rot in range(ROTATIONS):
                    # the reference's lane mix rotated with j (the metric
                    # rounds), and the k / nbr knobs rotated again within it
                    lane_k = [ks[(i + j + rot) % len(ks)] for i in range(B)]
                    lane_nbr = [nbrs[(i + j + rot) % len(nbrs)]
                                for i in range(B)]
                    lane_m = [metrics[(i + j) % len(metrics)]
                              for i in range(B)]
                    lane_m[0] = met
                    if B > 1:
                        lane_k[-1] = 0          # one dead padding lane
                    has_dtw = any(m == "dtw" and kk > 0
                                  for m, kk in zip(lane_m, lane_k))
                    launches: list = []
                    out.append(censused(
                        ("bucket", j, B, rot),
                        lambda: bucket_call(lane_k, lane_nbr, lane_m,
                                            launches),
                        budget=BOUNDARY_SYNCS, group=(B, has_dtw),
                        launches=launches))
        return out

    passes, builds, loads = [], [], []
    for _ in range(2):
        with _Counting() as cnt:
            passes.append(tuple(one_pass()))
        builds.append(cnt.builds)
        loads.append(cnt.loads)
    return SweepReport(tuple(passes), tuple(builds), tuple(loads))


def _violations(rep: SweepReport) -> list[str]:
    v = []
    if rep.builds[1]:
        v.append(f"pass 2 built {rep.builds[1]} DeviceIndex layout(s) — a "
                 f"call rebuilds device state instead of reusing the "
                 f"cached layout")
    if rep.loads[1]:
        v.append(f"pass 2 built the kernel library {rep.loads[1]} time(s)")
    for a, b in zip(*rep.passes):
        for what in ("kernel_calls", "kernel_sequence", "aten_ops",
                     "aten_sequence", "host_syncs"):
            if getattr(a, what) != getattr(b, what):
                v.append(f"{b.key}: {what} changed on the warm pass: "
                         f"{getattr(a, what)!r} -> {getattr(b, what)!r}")
        n = sum(b.host_syncs.values())
        if b.budget is not None and n > b.budget:
            v.append(f"{b.key}: {n} host syncs over the budget of "
                     f"{b.budget} ({b.host_syncs}) — a per-step host read")
    groups: dict = {}
    for c in rep.passes[0] + rep.passes[1]:
        if c.launch is None:
            continue
        n = sum(c.launch["host_syncs"].values())
        if n:
            v.append(f"{c.key}: {n} host sync(s) in bucket_search_launch "
                     f"({c.launch['host_syncs']})")
        seq = (c.launch["kernel_sequence"], c.launch["aten_sequence"])
        groups.setdefault(c.group, {}).setdefault(seq, []).append(c.key)
    for group, seqs in groups.items():
        if len(seqs) > 1:
            v.append(f"bucket shape {group}: the launch sequence follows the "
                     f"lanes' knobs ({len(seqs)} sequences: "
                     f"{sorted(seqs.values())}) — a knob leaked into the "
                     f"launch structure")
    return v


def verify_sweep(report: SweepReport | None = None, **kw) -> SweepReport:
    """Raise :class:`RecompileViolation` unless the sweep is steady-state."""
    rep = report if report is not None else run_sweep(**kw)
    v = rep.violations
    if v:
        raise RecompileViolation(
            f"{len(v)} steady-state violation(s) over {rep.combos} "
            f"combinations:\n  " + "\n  ".join(v))
    return rep
