"""The analysis gates on the card: the audit of every registered entry on
CUDA against the CPU golden, the steady-state sweep, and ``no_host_sync``
raising on a device read.  Imports no ``jax``, so it runs where the card
is::

    python -m pytest -q -m cuda tests/test_torch_analysis_cuda.py

everywhere else every case skips with a reason.

On the card the host syncs are the warnings of
``torch.cuda.set_sync_debug_mode("warn")``; for the ``shape_fixed``
entries they and the kernel calls must equal the CPU census in the golden
exactly (``repro_torch.analysis.audit``)."""
import pytest
import torch

from _torch_port import cuda, torch_threads  # noqa: F401
from repro_torch.analysis import audit, contracts, guards, registry
from repro_torch.analysis.recompile import verify_sweep
from repro_torch.kernels import (dtw_band, lb_improved, lb_isax, lb_keogh,
                                 pairwise_l2, sax_encode)

pytestmark = pytest.mark.cuda

MODS = {"sax_encode": sax_encode, "pairwise_l2": pairwise_l2,
        "lb_paa_interval": lb_isax, "lb_keogh": lb_keogh,
        "lb_improved": lb_improved, "dtw_band": dtw_band}


def test_audit_on_the_card_against_the_golden(cuda, capsys):
    """Every entry runs its kernels on the card, with no float64, no sync
    in a sync-free entry, and the CPU's kernel calls and host syncs where
    the loops follow the shapes; every kernel call the census counts is a
    launch of the kernel."""
    state = registry.audit_state(cuda)
    for e in registry.entries():
        e.setup(state)()                    # the first launches load modules
    torch.cuda.synchronize()
    for m in MODS.values():
        m.launches = 0
    results = {}
    for e in registry.entries():
        results[e.name] = contracts.run_entry(e, cuda, warm=False)[1] \
            .contract()
    assert audit.run_audit(device="cuda", results=results) == 0, \
        capsys.readouterr()
    calls = {name: sum(c["kernel_calls"]["histogram"].get(name, 0)
                       for c in results.values()) for name in MODS}
    assert calls == {name: m.launches for name, m in MODS.items()}
    assert all(calls.values())
    assert all(c["peak_bytes"] > 0 for c in results.values())


def test_sweep_is_steady_on_the_card(cuda):
    rep = verify_sweep(device=cuda)
    assert rep.launch_syncs == 0
    assert rep.builds == (0, 0) and rep.loads == (0, 0)


def test_no_host_sync_raises_on_a_device_read(cuda):
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError, match="synchroniz"):
        with guards.no_host_sync(cuda):
            x.sum().item()
    prev = torch.cuda.get_sync_debug_mode()
    with guards.no_host_sync(cuda):
        y = x * 2                               # queues, waits for nothing
    assert torch.cuda.get_sync_debug_mode() == prev
    assert float(y.sum()) == 8.0
