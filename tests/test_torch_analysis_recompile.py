"""The steady-state sweep (``repro_torch.analysis.recompile``) on the CPU:
the k/nbr/metric/batch grid and the serving bucket ladder repeat their
first pass exactly on the second, and the gate trips on a wrapper that
rebuilds the ``DeviceIndex`` per call, on a bucket whose launches follow a
lane's ``nbr`` (the eager form of a knob leaked into a static), and on a
per-step host read that blows the sync budget."""
import pytest

from _torch_port import torch_threads  # noqa: F401
from repro_torch.analysis.recompile import (BOUNDARY_SYNCS, SWEEP_CHUNK,
                                            RecompileViolation, SweepReport,
                                            run_sweep, sync_budget,
                                            verify_sweep)
from repro_torch.core import search_device as sd
from repro_torch.core.build import DumpyParams
from repro_torch.core.device_index import DeviceIndex
from repro_torch.core.index import DumpyIndex
from repro_torch.core.sax import SaxParams
from repro_torch.core.split import SplitParams
from repro_torch.data.series import random_walks

CPU = "cpu"


@pytest.fixture(scope="module")
def small_index():
    """The reference's ``small_index`` (1500 × 64, w=8, b=8, th=128)."""
    db = random_walks(1500, 64, seed=11)
    p = DumpyParams(sax=SaxParams(w=8, b=8), split=SplitParams(th=128))
    return DumpyIndex.build(db, p)


def test_sweep_steady_state(small_index):
    rep = run_sweep(small_index, ks=(3, 5), nbrs=(2,), metrics=("ed", "dtw"),
                    batches=(2, 4), buckets=(), device=CPU)
    assert rep.ok, rep.violations
    assert rep.builds == (0, 0) and rep.loads == (0, 0)
    assert rep.combos == 2 * (2 * 2 + 1)
    for a, b in zip(*rep.passes):
        assert a == b
        assert sum(b.host_syncs.values()) <= b.budget
    verify_sweep(rep)                        # does not raise


def test_bucket_ladder_steady_state(small_index):
    """Every bucket shape, fed rotated knob mixes (a dead lane included),
    launches one sequence of kernels and aten ops per (lanes, has_dtw) and
    waits for nothing inside ``bucket_search_launch``."""
    rep = run_sweep(small_index, ks=(3, 5), nbrs=(2, 4),
                    metrics=("ed", "dtw"), batches=(2,), buckets=(1, 2, 4),
                    device=CPU)
    assert rep.ok, rep.violations
    buckets = [c for c in rep.passes[1] if c.launch is not None]
    assert len(buckets) == 2 * 3 * 2
    assert rep.launch_syncs == 0
    assert {c.group for c in buckets} >= {(4, True), (1, False), (1, True)}
    verify_sweep(rep)


def test_gate_trips_on_a_device_index_rebuilt_per_call(small_index):
    """A wrapper that builds its own layout on every call (bypassing the
    index's cache) repeats the cold call's work on the warm pass."""
    def leaky_exact(index, qs, k, metric="ed", chunk=2048, device=CPU):
        dev = DeviceIndex.from_index(index, chunk=chunk, device=device)
        return sd.exact_search_device_batch(index, qs, k, metric=metric,
                                            dev=dev)

    with pytest.raises(RecompileViolation, match="pass 2 built 2 Device"):
        verify_sweep(index=small_index, ks=(3,), nbrs=(2,), metrics=("ed",),
                     batches=(2, 4), buckets=(), device=CPU,
                     exact_fn=leaky_exact)


def test_gate_trips_on_a_knob_in_the_launch_structure(small_index):
    """A bucket wrapper that sizes the program by the first lane's ``nbr``
    (not the pinned ``nbr_max``) scans a different number of leaf ranks
    for each knob rotation of one bucket shape."""
    def leaky_bucket(index, qs, ks, nbrs, metrics=None, **kw):
        kw["nbr_max"] = nbrs[0]
        return sd.bucket_search_device_batch(index, qs, ks, nbrs, metrics,
                                             **kw)

    with pytest.raises(RecompileViolation, match="follows the lanes' knobs"):
        verify_sweep(index=small_index, ks=(3,), nbrs=(2, 4),
                     metrics=("ed",), batches=(2,), buckets=(1, 2),
                     device=CPU, bucket_fn=leaky_bucket)


def test_gate_trips_on_a_per_step_host_read(small_index, monkeypatch):
    """A ``.item()`` in every merge step of the span loop (a debugging read
    left behind) is the same on both passes, so only the budget sees it."""
    orig = sd.ops.topk_merge

    def merge_and_read(topd, topi, d2, ids):
        out = orig(topd, topi, d2, ids)
        out[0][0, -1].item()
        return out

    monkeypatch.setattr(sd.ops, "topk_merge", merge_and_read)
    with pytest.raises(RecompileViolation, match="over the budget"):
        verify_sweep(index=small_index, ks=(3,), nbrs=(2,), metrics=("ed",),
                     batches=(2,), buckets=(), device=CPU)


def test_sync_budget_counts_stop_tests(small_index):
    dev = small_index.device_index(chunk=SWEEP_CHUNK, device=CPU)
    W = dev.win_start.shape[1]
    assert sync_budget("exact", dev, q=4, k=3, metric="ed") \
        == BOUNDARY_SYNCS + 1 + -(-W // sd.STOP_CHECK_EVERY)
    assert sync_budget("exact", dev, q=4, k=3, metric="dtw") > BOUNDARY_SYNCS
    assert sync_budget("bucket", dev, q=4, k=3, metric="ed") \
        == BOUNDARY_SYNCS
    with pytest.raises(RecompileViolation, match="pass 2 built the kernel"):
        verify_sweep(SweepReport(((), ()), (0, 0), (0, 1)))
    verify_sweep(SweepReport(((), ()), (0, 0), (1, 0)))   # a cold build
