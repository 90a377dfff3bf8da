import os
import sys

# Tests must see exactly 1 device (the dry-run sets its own 512-device flag
# in a subprocess).  Keep XLA on a deterministic single-threaded-ish setup.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "guard_transfers: run under jax.transfer_guard('disallow') — any "
        "implicit device<->host transfer inside the test raises (explicit "
        "jnp.asarray/np.asarray conversions stay allowed)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the repro_torch kernels); skips with a "
        "reason where there is none")


@pytest.fixture(autouse=True)
def _transfer_guard(request):
    """Opt-in transfer guard (``@pytest.mark.guard_transfers``).

    The device search paths promise device-residency between the input
    upload and the result download; a silent ``__array__`` coercion in the
    middle (e.g. a host float leaking into a jnp op) would still pass the
    numeric tests while wrecking the serving story.  Under the guard such
    transfers fail loudly.  Subprocess-based tests are unaffected (the
    guard is per-process).

    ``@pytest.mark.guard_transfers(False)`` opts a single test back out of
    a module-level mark — for property tests that call jit-internal helpers
    *eagerly* (eager ``fori_loop``/Pallas bounds legitimately transfer
    host scalars; under jit they are trace-time constants)."""
    marker = request.node.get_closest_marker("guard_transfers")
    if marker is None or (marker.args and not marker.args[0]):
        yield
        return
    import jax

    with jax.transfer_guard("disallow"):
        yield
