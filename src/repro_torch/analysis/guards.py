"""A host-sync guard for tests and checks: the twin of the reference's
``guard_transfers`` test marker (``jax.transfer_guard("disallow")``).

    with no_host_sync("cuda"):
        bucket_search_launch(index, qs_dev, lane_nbr, lane_dtw, ...)

On CUDA it is ``torch.cuda.set_sync_debug_mode("error")``: any operation
that waits for the device raises, ``.item()``, ``.cpu()``, ``nonzero`` and
uploads from pageable memory included; the previous mode comes back on
exit.  On the CPU, where nothing waits, it is a strict
:class:`~repro_torch.analysis.contracts.Census` that raises
:class:`~repro_torch.analysis.contracts.HostSyncError` at the first call a
card would wait in (the sync-inducing aten ops on a device tensor and the
transfers across the host boundary).  It is a context manager, not a
fixture: a test states the block it guards.
"""
from __future__ import annotations

import contextlib

import torch

from .contracts import Census, HostSyncError  # noqa: F401  (re-exported)


@contextlib.contextmanager
def no_host_sync(device: str | torch.device = "cuda"):
    """Raise on any host sync inside the block (see the module
    docstring)."""
    if torch.device(device).type == "cuda":
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    else:
        with Census(device, strict=True):
            yield
