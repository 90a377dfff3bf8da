"""The port's LM substrate (``repro_torch.models``, ``repro_torch.configs``)
against the reference on the dense, MoE, VLM and encoder-decoder
architectures, plus the configs and the logical-axis names.

Each reduced architecture runs on the reference's own parameters
(``PRNGKey(0)``), carried across by ``repro_torch.models.weights``:
``forward_train`` logits and ``loss_fn``, ``forward_prefill`` (last
logits and every cache leaf), and ``forward_decode`` from the reference's
grown prefill cache (logits and new caches), at ``_torch_port.model_tol``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from _torch_port import (assert_tree_close, check_decode, check_prefill,
                         check_prefill_decode_consistency,
                         check_train_and_loss, model_reference, model_tol,
                         port_grads, port_model, torch_batch,
                         torch_threads)  # noqa: F401

DENSE = ["whisper-base", "llama4-scout-17b-a16e", "phi3.5-moe-42b-a6.6b",
         "mistral-nemo-12b", "llama3-405b", "olmo-1b", "qwen3-32b",
         "llama-3.2-vision-90b"]
# architectures whose port gradients are also held against jax.grad
GRAD_PAIRS = ["olmo-1b", "phi3.5-moe-42b-a6.6b"]

pytestmark = pytest.mark.usefixtures("torch_threads")


def test_dense_list_and_registry_cover_every_architecture():
    from repro.models import registry as ref_registry
    from repro_torch.models import registry
    assert registry.ARCH_NAMES == ref_registry.ARCH_NAMES
    assert set(DENSE) | {"xlstm-1.3b", "recurrentgemma-9b"} == \
        set(registry.ARCH_NAMES)


@pytest.mark.parametrize("name", DENSE)
def test_forward_train_and_loss_match_reference(name):
    check_train_and_loss(name)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_logits_and_caches_match_reference(name):
    check_prefill(name)


@pytest.mark.parametrize("name", DENSE)
def test_decode_from_reference_cache_matches_reference(name):
    check_decode(name)


@pytest.mark.parametrize("name", DENSE)
def test_port_prefill_decode_consistency(name):
    check_prefill_decode_consistency(name)


@pytest.mark.parametrize("name", DENSE)
def test_port_grads_finite_and_nonzero(name):
    model = port_model(name)
    gn = port_grads(model, torch_batch(model_reference(name)["batch"]))
    assert np.isfinite(gn) and gn > 0


@pytest.mark.parametrize("name", GRAD_PAIRS)
def test_port_grads_match_jax_grad(name):
    """Every gradient leaf within rtol 1e-3 of ``jax.grad`` of the
    reference's ``loss_fn`` (atol 1e-3 of the leaf's largest gradient, for
    the entries that cancel to near 0)."""
    import jax
    from repro.models import registry
    from repro_torch.models import weights
    ref = model_reference(name)
    cfg = ref["cfg"]
    jb = {k: jax.numpy.asarray(v) for k, v in ref["batch"].items()}
    params = jax.tree.map(jax.numpy.asarray, ref["params"])
    want = jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p: registry.loss_fn(p, jb, cfg)))(params))
    model = port_model(name)
    port_grads(model, torch_batch(ref["batch"]))
    got = weights.params_to_reference(model, grads=True)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        g = flat_g[path]
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_moe_top_k_keeps_the_lower_expert_among_ties():
    from repro_torch.models.moe import top_k
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    w, e = top_k(probs, 2)
    assert e.tolist() == [[1, 2], [0, 1]]
    assert w.tolist() == [[0.30000001192092896, 0.30000001192092896],
                          [0.25, 0.25]]


def test_moe_apply_matches_reference_with_drops():
    """MoE at the production capacity factor 1.25, where overflowing
    tokens drop: the port's dispatch equals the reference's."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import MoEConfig as RMoE, reduced as rreduced
    from repro.models import moe as rmoe, registry as rreg
    from repro.models.common import materialize
    from repro_torch.configs.base import MoEConfig, reduced
    from repro_torch.models import moe, registry
    from repro_torch.models.transformer import Params
    rcfg = rreduced(rreg.get_config("phi3.5-moe-42b-a6.6b"),
                    moe=RMoE(n_experts=4, top_k=2, capacity_factor=1.25))
    cfg = reduced(registry.get_config("phi3.5-moe-42b-a6.6b"),
                  moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=1.25))
    p = materialize(rmoe.moe_specs(rcfg), jax.random.PRNGKey(3), jnp.float32)
    x = np.random.default_rng(3).standard_normal((2, 24, 64)).astype(np.float32)
    want = np.asarray(rmoe.moe_apply(p, jnp.asarray(x), rcfg))
    pp = Params({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    with torch.no_grad():
        got = moe.moe_apply(pp, torch.from_numpy(x), cfg).numpy()
    assert moe.capacity(cfg, 24) == rmoe.capacity(rcfg, 24) == 15
    assert moe.capacity(cfg, 1) == rmoe.capacity(rcfg, 1) == 2
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_cell_applicability_rules():
    from repro_torch.configs.base import SHAPES, cell_applicable
    from repro_torch.models import registry
    rows = {n: dict((s, cell_applicable(registry.get_config(n), SHAPES[s])[0])
                    for s in SHAPES) for n in registry.ARCH_NAMES}
    assert rows["xlstm-1.3b"]["long_500k"]
    assert rows["recurrentgemma-9b"]["long_500k"]
    assert not rows["llama3-405b"]["long_500k"]
    assert all(rows[n]["train_4k"] for n in registry.ARCH_NAMES)
    from repro.models import registry as ref_registry
    for n in registry.ARCH_NAMES:
        assert registry.applicable_cells(n) == ref_registry.applicable_cells(n)


def test_param_counts_match_nameplate():
    """The reference's nameplate bounds, and every full config's count
    equal to the reference's."""
    from repro.models import registry as ref_registry, transformer as ref_tfm
    from repro_torch.models import registry, transformer as tfm
    expect = {"llama3-405b": 405e9, "qwen3-32b": 32e9, "mistral-nemo-12b": 12e9,
              "olmo-1b": 1.2e9, "xlstm-1.3b": 1.3e9, "recurrentgemma-9b": 9e9,
              "phi3.5-moe-42b-a6.6b": 42e9}
    for name, n in expect.items():
        got = tfm.count_params(registry.get_config(name))
        assert 0.8 * n < got < 1.35 * n, (name, got)
    for name in registry.ARCH_NAMES:
        assert tfm.count_params(registry.get_config(name)) == \
            ref_tfm.count_params(ref_registry.get_config(name)), name


def test_port_init_matches_reference_shapes_and_scales():
    """``init_params`` builds the reference's tree (every leaf's shape,
    through ``params_to_reference``) with its distributions: the stacked
    leaves' stddev 1/sqrt(n_units), 0.02 for the embedding, zeros for the
    norms."""
    from repro_torch.configs.base import reduced
    from repro_torch.models import registry, transformer as tfm, weights
    for name in ("olmo-1b", "llama-3.2-vision-90b", "whisper-base"):
        cfg = reduced(registry.get_config(name))
        model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        got = weights.params_to_reference(model)
        ref = model_reference(name)["params"]
        shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else v.shape
                            for k, v in t.items()}  # noqa: E731
        assert shapes(got) == shapes(ref), name
    cfg = dataclasses.replace(reduced(registry.get_config("olmo-1b")),
                              n_layers=4, d_model=256, d_ff=512)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert len(model.units) == 4
    with torch.no_grad():
        wq = torch.stack([u["b0"].attn.wq for u in model.units])
        assert abs(float(wq.std()) - 0.5) < 0.01      # 1/sqrt(n_units)
        assert abs(float(model.embed.std()) - 0.02) < 0.001
        assert abs(float(model.lm_head.std()) - 1 / math.sqrt(256)) < 0.002


def test_configs_equal_reference_field_by_field():
    from repro.configs import base as ref_base
    from repro.models import registry as ref_registry
    from repro_torch.configs import base
    from repro_torch.models import registry
    for name in registry.ARCH_NAMES:
        got, want = registry.get_config(name), ref_registry.get_config(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert dataclasses.asdict(base.reduced(got)) == \
            dataclasses.asdict(ref_base.reduced(want)), name
        assert (got.n_units, got.remainder_pattern, got.q_dim, got.kv_dim) == \
            (want.n_units, want.remainder_pattern, want.q_dim, want.kv_dim)
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()}


def test_sharding_rules_resolution_no_mesh_is_noop():
    from repro_torch.distributed.sharding import DEFAULT_RULES, logical_rules, shard
    x = torch.ones((4, 8))
    assert shard(x, "batch", "embed") is x          # no mesh → identity
    with logical_rules(None, DEFAULT_RULES):
        assert shard(x, "batch", "embed") is x      # rules, no mesh


def test_sharding_rules_drop_conflicts_and_missing_axes():
    from repro.distributed import sharding as ref_sharding
    from repro_torch.distributed.sharding import (DEFAULT_RULES, logical_rules,
                                                  logical_spec)
    assert DEFAULT_RULES == ref_sharding.DEFAULT_RULES
    with logical_rules(("model",), DEFAULT_RULES):
        spec = logical_spec(("heads", "mlp"))       # both map to 'model'
        # second use of the same mesh axis must be dropped
        assert spec[0] == "model" and spec[1] is None
        spec2 = logical_spec(("batch",))            # pod/data not in mesh
        assert spec2[0] is None
    with logical_rules(("pod", "data", "model"), DEFAULT_RULES):
        assert logical_spec(("batch", "seq", "vocab")) == \
            (("pod", "data"), None, "model")
    assert logical_spec(("batch",)) == ()           # rules restored


def test_shard_raises_under_rules_and_a_mesh():
    """Under rules over axis names alone ``shard`` raises (names resolve,
    but there are no ranks to place on); under a one-rank ``DeviceMesh``
    it redistributes a DTensor to its names' placements and passes a
    plain tensor through."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs.base import reduced
    from repro_torch.distributed.sharding import (DEFAULT_RULES,
                                                  logical_rules, named_mesh,
                                                  place, shard)
    from repro_torch.models import registry, transformer as tfm
    x = torch.ones((4, 8))
    with logical_rules(("data", "model"), DEFAULT_RULES):
        with pytest.raises(NotImplementedError, match="DeviceMesh"):
            shard(x, "batch", "embed")
        cfg = reduced(registry.get_config("olmo-1b"))
        model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(NotImplementedError, match="DeviceMesh"):
            tfm.forward_train(model, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = named_mesh((1, 1), ("data", "model"), "cpu")
        with logical_rules(mesh, DEFAULT_RULES):
            d = place(x, (Replicate(), Replicate()), mesh)
            y = shard(d, "batch", "mlp")
            assert tuple(y.placements) == (Shard(0), Shard(1))
            assert torch.equal(y.full_tensor(), x)
            assert shard(x, "batch", "mlp") is x
    finally:
        dist.destroy_process_group()


def test_local_attention_window_mask():
    """lattn must ignore keys beyond the window; the port's attention
    equals the reference's on the same inputs."""
    import jax.numpy as jnp
    from repro.models.common import attention as ref_attention
    from repro_torch.models.common import attention
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 12, 2, 8)).astype(np.float32)
               for _ in range(3))
    t = torch.from_numpy
    out_w = attention(t(q), t(k), t(v), causal=True, window=4, chunk=4)
    k2 = k.copy()
    k2[:, 0] += 100.0
    out_w2 = attention(t(q), t(k2), t(v), causal=True, window=4, chunk=4)
    np.testing.assert_allclose(out_w[:, 4:].numpy(), out_w2[:, 4:].numpy(),
                               atol=1e-5)
    for causal, window, chunk in ((True, 4, 4), (True, 0, 5), (False, 0, 8)):
        want = np.asarray(ref_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        window=window, chunk=chunk))
        got = attention(t(q), t(k), t(v), causal=causal, window=window,
                        chunk=chunk).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_decode_writes_the_last_cache_slot():
    """``forward_decode`` at the last position of a pre-sized random cache
    matches the reference, logits and every cache leaf.  (The decode
    tests above write the last slot too: position 31 of a cache grown to
    32, and recurrentgemma's ring slot 31 % 8 = 7 of 8.)"""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import reduced as rreduced
    from repro.models import registry as rreg, transformer as rtfm
    from repro_torch.configs.base import reduced
    from repro_torch.models import registry, transformer as tfm, weights
    for name in ("olmo-1b", "llama-3.2-vision-90b"):
        rcfg = rreduced(rreg.get_config(name))
        cfg = reduced(registry.get_config(name))
        rng = np.random.default_rng(5)
        cache = jax.tree.map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
            rtfm.init_cache(rcfg, 2, 12))
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        pos = 11                                   # the last slot of 12
        ref = model_reference(name)
        want_l, want_c = rtfm.forward_decode(
            jax.tree.map(jnp.asarray, ref["params"]), cache, jnp.asarray(tok),
            jnp.int32(pos), rcfg)
        model = port_model(name)
        caches = weights.cache_from_reference(
            cfg, jax.tree.map(np.asarray, cache), "cpu")
        with torch.no_grad():
            got_l, got_c = tfm.forward_decode(model, caches,
                                              torch.from_numpy(tok), pos)
        tol = model_tol(name)
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                                   atol=tol, rtol=tol)
        assert_tree_close(weights.cache_to_reference(got_c),
                          jax.tree.map(np.asarray, want_c), tol, "decode cache")


def test_init_cache_matches_reference_layout():
    import jax
    from repro.configs.base import reduced as rreduced
    from repro.models import registry as rreg, transformer as rtfm
    from repro_torch.configs.base import reduced
    from repro_torch.models import registry, transformer as tfm, weights
    for name in registry.ARCH_NAMES:
        got = weights.cache_to_reference(
            tfm.init_cache(reduced(registry.get_config(name)), 2, 8, "cpu"))
        want = rtfm.init_cache(rreduced(rreg.get_config(name)), 2, 8)
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_g) == len(flat_w), name
        for path, w in flat_w:
            assert flat_g[path].shape == w.shape, (name, path)
            assert not flat_g[path].any()


def test_remat_and_step_functions_match_the_direct_calls():
    """``remat`` (a unit recomputed in the backward pass) leaves the loss
    and every gradient bitwise as they were; the registry's step functions
    are the direct calls; ``aux_load_balance_loss`` equals the
    reference's."""
    import jax.numpy as jnp
    from repro.models import moe as rmoe
    from repro_torch.configs.base import reduced
    from repro_torch.models import moe, registry, transformer as tfm
    name = "olmo-1b"
    batch = torch_batch(model_reference(name)["batch"])
    grads = []
    for remat in ("none", "full"):
        cfg = dataclasses.replace(reduced(registry.get_config(name)),
                                  n_layers=2, remat=remat)
        model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        loss = registry.make_eval_step(cfg)(model, batch)
        loss.backward()
        grads.append([loss.detach()] + [p.grad for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    with torch.no_grad():
        pre = dict(batch, tokens=batch["tokens"][:, :8])
        l1, c1 = registry.make_prefill_step(cfg)(model, pre)
        l2, c2 = tfm.forward_prefill(model, pre)
        assert torch.equal(l1, l2)
        c1 = tfm.grow_cache(c1, 8, 9)
        c2 = tfm.grow_cache(c2, 8, 9)
        d1, _ = registry.make_decode_step(cfg)(
            model, {"cache": c1, "token": batch["tokens"][:, 8:9], "pos": 8})
        d2, _ = tfm.forward_decode(model, c2, batch["tokens"][:, 8:9], 8)
        assert torch.equal(d1, d2)
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 6, 4)).astype(np.float32)
    top_e = rng.integers(0, 4, (2, 6, 2))
    want = float(rmoe.aux_load_balance_loss(jnp.asarray(logits),
                                            jnp.asarray(top_e), 4))
    got = float(moe.aux_load_balance_loss(torch.from_numpy(logits),
                                          torch.from_numpy(top_e), 4))
    np.testing.assert_allclose(got, want, rtol=1e-6)
