"""The CUDA kernels against their plain PyTorch twins, on the card, over the
shape sweeps of ``test_kernels.py``.  Imports no ``jax``, so it runs where
the card is (``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``);
everywhere else every case skips with a reason."""
import numpy as np
import pytest
import torch

from _torch_port import (L2_SWEEP, LB_SWEEP, SAX_SWEEP, clear_of_breakpoints,
                         cuda, intervals, torch_threads)  # noqa: F401
from repro_torch.kernels import ops, ref, sax_encode

RNG = np.random.default_rng(43)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("B,n,w,b", SAX_SWEEP)
def test_sax_encode_kernel_matches_twin(cuda, B, n, w, b):
    x = torch.from_numpy(RNG.standard_normal((B, n)).astype(np.float32)).to(cuda)
    before = sax_encode.launches
    paa, sax = ops.sax_encode(x, w, b)
    assert sax_encode.launches == before + 1
    paa_r, sax_r = ref.sax_encode_ref(x, w, b)
    torch.testing.assert_close(paa, paa_r, rtol=1e-6, atol=1e-6)
    clear = torch.from_numpy(clear_of_breakpoints(paa_r.cpu().numpy(), b))
    assert torch.equal(sax.cpu()[clear], sax_r.cpu()[clear])


@pytest.mark.parametrize("Q,X,n", L2_SWEEP)
def test_pairwise_l2_kernel_matches_twin(cuda, Q, X, n):
    torch.backends.cuda.matmul.allow_tf32 = False
    q = torch.from_numpy(RNG.standard_normal((Q, n)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(RNG.standard_normal((X, n)).astype(np.float32)).to(cuda)
    got = ops.pairwise_l2(q, x)
    want = ref.pairwise_l2_ref(q, x)
    scale = (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("Q,L,w,n", LB_SWEEP)
def test_lb_paa_interval_kernel_matches_twin(cuda, Q, L, w, n):
    sl, sh, lo, hi = intervals(RNG, Q, L, w)
    lo[-1] = hi[-1] = np.inf                         # the +inf pad leaf
    t = [torch.from_numpy(a).to(cuda) for a in (sl, sh, lo, hi)]
    got = ops.lb_paa_interval(*t, n)
    want = ref.lb_paa_interval_ref(*t, n)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
