"""The port's LM substrate against the reference on the recurrent
architectures: Griffin (recurrentgemma-9b: RG-LRU and local attention)
and xLSTM (xlstm-1.3b: chunkwise mLSTM and sLSTM).

The whole reduced models run on the reference's own parameters as in
``test_torch_models_dense.py``, at ``_torch_port.model_tol`` (xlstm-1.3b
also within twice the reference's own movement under a one-ulp change of
its embedding, ``_torch_port.ULP_BOUND``); the blocks
run alone against the reference's ``rglru_apply`` / ``mlstm_apply`` /
``slstm_apply`` and against their own step-by-step decode.
"""
import numpy as np
import pytest
import torch

from _torch_port import (check_decode, check_prefill,
                         check_prefill_decode_consistency,
                         check_train_and_loss, model_reference, port_grads,
                         port_model, torch_batch, torch_threads)  # noqa: F401

RECURRENT = ["xlstm-1.3b", "recurrentgemma-9b"]

pytestmark = pytest.mark.usefixtures("torch_threads")


@pytest.mark.parametrize("name", RECURRENT)
def test_forward_train_and_loss_match_reference(name):
    check_train_and_loss(name)


@pytest.mark.parametrize("name", RECURRENT)
def test_prefill_logits_and_caches_match_reference(name):
    check_prefill(name)


@pytest.mark.parametrize("name", RECURRENT)
def test_decode_from_reference_cache_matches_reference(name):
    check_decode(name)


@pytest.mark.parametrize("name", RECURRENT)
def test_port_prefill_decode_consistency(name):
    check_prefill_decode_consistency(name)


@pytest.mark.parametrize("name", RECURRENT)
def test_port_grads_finite_and_nonzero(name):
    model = port_model(name)
    gn = port_grads(model, torch_batch(model_reference(name)["batch"]))
    assert np.isfinite(gn) and gn > 0


def _block_params(specs, seed):
    import jax
    import jax.numpy as jnp
    from repro.models.common import materialize
    from repro_torch.models.transformer import Params
    p = materialize(specs, jax.random.PRNGKey(seed), jnp.float32)
    return p, Params({k: torch.from_numpy(np.array(v)) for k, v in p.items()})


def test_rglru_recurrence_matches_stepwise():
    """The doubling scan's prefill ≡ sequential decode steps (Griffin
    block), and both ≡ the reference's ``rglru_apply``, also from a state."""
    import jax.numpy as jnp
    from repro.configs.base import reduced as rreduced
    from repro.models import griffin as rgriffin, registry as rreg
    from repro_torch.configs.base import reduced
    from repro_torch.models import griffin, registry
    rcfg = rreduced(rreg.get_config("recurrentgemma-9b"))
    cfg = reduced(registry.get_config("recurrentgemma-9b"))
    p_ref, p = _block_params(rgriffin.rglru_specs(rcfg), 0)
    r = cfg.rnn_dim or cfg.d_model
    x = np.random.default_rng(1).standard_normal((1, 8, cfg.d_model)
                                                 ).astype(np.float32)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y_seq, st_seq = griffin.rglru_apply(p, xt, cfg, None)
        st = {"h": torch.zeros((1, r)),
              "conv": torch.zeros((1, cfg.conv_width - 1, r))}
        outs = []
        for t in range(8):
            y, st = griffin.rglru_decode(p, xt[:, t:t + 1], cfg, st)
            outs.append(y)
    np.testing.assert_allclose(y_seq.numpy(), torch.cat(outs, 1).numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st_seq["h"].numpy(), st["h"].numpy(), atol=1e-4)
    y_ref, st_ref = rgriffin.rglru_apply(p_ref, jnp.asarray(x), rcfg, None)
    np.testing.assert_allclose(y_seq.numpy(), np.asarray(y_ref),
                               atol=1e-5, rtol=1e-5)
    for k in ("h", "conv"):
        np.testing.assert_allclose(st_seq[k].numpy(), np.asarray(st_ref[k]),
                                   atol=1e-5, rtol=1e-5)
    # from a state: the seed folds into step 0
    with torch.no_grad():
        y2, st2 = griffin.rglru_apply(p, xt, cfg, st_seq)
    y2_ref, st2_ref = rgriffin.rglru_apply(
        p_ref, jnp.asarray(x), rcfg, {k: jnp.asarray(v.numpy())
                                      for k, v in st_seq.items()})
    np.testing.assert_allclose(y2.numpy(), np.asarray(y2_ref),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st2["h"].numpy(), np.asarray(st2_ref["h"]),
                               atol=1e-5, rtol=1e-5)


def test_linear_scan_matches_a_sequential_loop():
    from repro_torch.models.griffin import linear_scan
    rng = np.random.default_rng(2)
    for S in (1, 2, 5, 8, 33):
        a = rng.uniform(0.5, 1.0, (3, S, 7))
        b = rng.standard_normal((3, S, 7))
        h, want = np.zeros((3, 7)), []
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        got = linear_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, np.stack(want, 1), rtol=1e-12,
                                   atol=1e-12)


def test_mlstm_chunked_matches_decode():
    """Chunkwise parallel form ≡ stepwise recurrence (xLSTM mLSTM), and ≡
    the reference's ``mlstm_apply`` (also at a sequence of two chunks);
    sLSTM ≡ the reference's ``slstm_apply``."""
    import jax.numpy as jnp
    from repro.configs.base import reduced as rreduced
    from repro.models import registry as rreg, xlstm as rxlstm
    from repro_torch.configs.base import reduced
    from repro_torch.models import registry, xlstm
    rcfg = rreduced(rreg.get_config("xlstm-1.3b"))
    cfg = reduced(registry.get_config("xlstm-1.3b"))
    p_ref, p = _block_params(rxlstm.mlstm_specs(rcfg), 0)
    x = 0.5 * np.random.default_rng(1).standard_normal((1, 16, cfg.d_model)
                                                       ).astype(np.float32)
    xt = torch.from_numpy(x)
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    with torch.no_grad():
        y_seq, st_seq = xlstm.mlstm_apply(p, xt, cfg, None)
        st = {"C": torch.zeros((1, nh, dh, dh)), "n": torch.zeros((1, nh, dh))}
        outs = []
        for t in range(16):
            y, st = xlstm.mlstm_decode(p, xt[:, t:t + 1], cfg, st)
            outs.append(y)
    np.testing.assert_allclose(y_seq.numpy(), torch.cat(outs, 1).numpy(),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(st_seq["C"].numpy(), st["C"].numpy(),
                               atol=1e-3, rtol=1e-3)
    y_ref, st_ref = rxlstm.mlstm_apply(p_ref, jnp.asarray(x), rcfg, None)
    np.testing.assert_allclose(y_seq.numpy(), np.asarray(y_ref),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st_seq["C"].numpy(), np.asarray(st_ref["C"]),
                               atol=1e-5, rtol=1e-5)
    # two chunks of MLSTM_CHUNK steps, from a state
    x2 = 0.5 * np.random.default_rng(3).standard_normal(
        (1, 2 * xlstm.MLSTM_CHUNK, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        y2, st2 = xlstm.mlstm_apply(p, torch.from_numpy(x2), cfg, st_seq)
    y2_ref, st2_ref = rxlstm.mlstm_apply(
        p_ref, jnp.asarray(x2), rcfg,
        {k: jnp.asarray(v.numpy()) for k, v in st_seq.items()})
    np.testing.assert_allclose(y2.numpy(), np.asarray(y2_ref),
                               atol=1e-4, rtol=1e-4)
    for k in ("C", "n"):
        np.testing.assert_allclose(st2[k].numpy(), np.asarray(st2_ref[k]),
                                   atol=1e-4, rtol=1e-4)
    s_ref, s = _block_params(rxlstm.slstm_specs(rcfg), 4)
    with torch.no_grad():
        ys, sts = xlstm.slstm_apply(s, xt, cfg, None)
    ys_ref, sts_ref = rxlstm.slstm_apply(s_ref, jnp.asarray(x), rcfg, None)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_ref),
                               atol=1e-5, rtol=1e-5)
    for k in ("h", "c", "n"):
        np.testing.assert_allclose(sts[k].numpy(), np.asarray(sts_ref[k]),
                                   atol=1e-5, rtol=1e-5)


def test_mlstm_backward_is_finite_past_the_masked_exponent():
    """The exponent of the upper triangle is masked to -30 before ``exp``,
    so the backward pass of a long chunk has no inf·0."""
    from repro_torch.models.common import init_params
    from repro_torch.models.transformer import Params
    from repro_torch.configs.base import reduced
    from repro_torch.models import registry, xlstm
    cfg = reduced(registry.get_config("xlstm-1.3b"))
    p = Params(init_params(xlstm.mlstm_specs(cfg),
                           torch.Generator().manual_seed(0), torch.float32,
                           torch.device("cpu")))
    x = torch.from_numpy(4 * np.random.default_rng(0).standard_normal(
        (1, 64, cfg.d_model)).astype(np.float32)).requires_grad_()
    y, _ = xlstm.mlstm_apply(p, x, cfg, None)
    y.sum().backward()
    assert torch.isfinite(x.grad).all()
    assert all(torch.isfinite(t.grad).all() for t in p.parameters())
