"""The port's training substrate (``repro_torch.data.tokens`` and
``repro_torch.train``) against the reference, on reduced OLMo-1B with the
reference's own parameters (``PRNGKey(0)``) carried across by
``repro_torch.models.weights``.  The first eleven tests are the twins of
``tests/test_train_substrate.py``'s; the rest hold the port to the
reference on the same numbers.

Tolerances (measured on the CPU in brackets):

* ``batch_at``, ``quantize_int8`` / ``dequantize_int8`` and
  ``compressed_psum`` in a world of one: bitwise;
* ``schedule``: rtol 1e-6 (XLA's and torch's float32 ``cos``);
* ``apply``, three steps on the same parameters and gradients: float32
  and ``chunk_stacked`` parameters and moments within atol = rtol = 1e-6
  [1.2e-7]; bf16 moments: parameters within atol 1e-5 [2.9e-6], moments
  within one bf16 ulp (rtol 2^-7, atol 1e-8); bf16 ``math_dtype``:
  parameters and moments within two bf16 ulps (rtol 2^-6) plus atol 1e-4
  after the three steps, each of which rounds the parameters to bf16 (XLA
  keeps float32 between bf16 operations, excess precision torch does not
  take) [1.5 ulps: 2.9e-3 at 0.25];
* one train step against the reference's jitted ``make_train_step``: loss
  rtol 1e-5, grad norm rtol 1e-4 (the port adds the leaves' squares in
  its own order), parameters atol 5e-5, a tenth of step 1's learning rate
  [3.2e-6]; the microbatched step the same [9.6e-6];
* ten steps' losses: rtol 1e-3 [3.7e-4] — AdamW's ``m / sqrt(v)`` turns a
  rounding of a near-zero gradient into a share of the learning rate,
  which the following steps carry on.

Files live under ``tmp_path``; the one signal goes to a child process
(``subprocess.run``) that sends it to itself.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import torch_threads  # noqa: F401
from repro.configs.base import reduced as r_reduced
from repro.data.tokens import TokenPipeline as RPipeline
from repro.data.tokens import TokenPipelineConfig as RPipelineConfig
from repro.models import registry as r_registry
from repro.models import transformer as r_tfm
from repro.train import grad_compress as r_gc
from repro.train import optimizer as r_opt
from repro.train.checkpoint import CheckpointManager as RCheckpointManager
from repro.train.checkpoint import _key_strs
from repro.train.train_step import make_microbatched_train_step as r_micro
from repro.train.train_step import make_train_step as r_make_train_step
from repro_torch.configs.base import reduced
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.models import registry, weights
from repro_torch.models.common import leaves
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.grad_compress import (compressed_psum,
                                             dequantize_int8, quantize_int8)
from repro_torch.train.train_step import (make_microbatched_train_step,
                                          make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=50)
BF16_ULP = 2.0 ** -7

pytestmark = pytest.mark.usefixtures("torch_threads")


@pytest.fixture(scope="module")
def ref():
    """The reference's reduced OLMo-1B, parameters and AdamW config, and
    its runs on them: ten jitted train steps on ``batch_at(0..9)`` (4 x 64)
    and one microbatched step (8 x 64, four microbatches)."""
    cfg = r_reduced(r_registry.get_config("olmo-1b"))
    params = r_tfm.init_params(cfg, jax.random.PRNGKey(0))
    ocfg = r_opt.AdamWConfig(**OCFG)
    pipe = _pipe(cfg.vocab)
    step = jax.jit(r_make_train_step(cfg, ocfg))
    p, s = params, r_opt.init(params, ocfg)
    losses = []
    for i in range(10):
        p, s, m = step(p, s, pipe.batch_at(i))
        losses.append(float(m["loss"]))
        if i == 0:
            first = SimpleNamespace(
                loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                params=jax.tree.map(np.asarray, p))
    micro = jax.jit(r_micro(cfg, ocfg, n_micro=4))
    mp, _, mm = micro(params, r_opt.init(params, ocfg),
                      _pipe(cfg.vocab, batch=8).batch_at(0))
    return SimpleNamespace(
        cfg=cfg, params=params, np=jax.tree.map(np.asarray, params),
        ocfg=ocfg, losses=losses, first=first,
        micro=SimpleNamespace(loss=float(mm["loss"]),
                              grad_norm=float(mm["grad_norm"]),
                              params=jax.tree.map(np.asarray, mp)))


@pytest.fixture(scope="module")
def small(ref):
    """The port's reduced OLMo-1B config and AdamW config, and a factory of
    fresh models on the reference's parameters."""
    cfg = reduced(registry.get_config("olmo-1b"))
    return SimpleNamespace(
        cfg=cfg, ocfg=opt.AdamWConfig(**OCFG),
        model=lambda: weights.model_from_reference(cfg, ref.np, "cpu"))


def _pipe(vocab, batch=4, seq=64, seed=0, cls=RPipeline, cfg_cls=RPipelineConfig):
    return cls(cfg_cls(vocab=vocab, seq_len=seq, global_batch=batch,
                       seed=seed))


def _port_pipe(vocab, batch=4, seq=64, seed=0):
    return _pipe(vocab, batch, seq, seed, TokenPipeline, TokenPipelineConfig)


def _close(got, want, atol, rtol, what):
    """Every leaf of two reference-layout trees allclose."""
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=rtol, err_msg=f"{what} {path}")


# ---------------------------------------------------------------------------
# twins of tests/test_train_substrate.py
# ---------------------------------------------------------------------------

def test_loss_decreases(small):
    model = small.model()
    step = make_train_step(small.cfg, small.ocfg)
    state = opt.init(weights.param_tree(model), small.ocfg)
    pipe = _port_pipe(small.cfg.vocab)
    losses = []
    for i in range(30):
        model, state, m = step(model, state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05
    assert np.isfinite(losses).all()


def test_microbatched_matches_tokens(small):
    pipe = _port_pipe(small.cfg.vocab, batch=8)
    b = pipe.batch_at(0)
    m1, m2 = small.model(), small.model()
    _, _, r1 = make_train_step(small.cfg, small.ocfg)(
        m1, opt.init(weights.param_tree(m1), small.ocfg), b)
    _, _, r2 = make_microbatched_train_step(small.cfg, small.ocfg, 4)(
        m2, opt.init(weights.param_tree(m2), small.ocfg), b)
    # same data, same params → same loss (averaged over microbatches)
    assert abs(float(r1["loss"]) - float(r2["loss"])) < 5e-2


def test_adamw_schedule():
    ocfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                           min_lr_ratio=0.1)
    at = lambda s: float(opt.schedule(ocfg, torch.tensor(s, dtype=torch.int32)))  # noqa: E731
    assert at(5) == pytest.approx(0.5)
    assert at(10) == pytest.approx(1.0, rel=1e-3)
    assert at(110) == pytest.approx(0.1, rel=1e-3)


def test_grad_clip():
    g = {"a": torch.full((4,), 10.0)}
    clipped, gn = opt.clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, rel=1e-5)


def test_quantize_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(5000).astype(np.float32))
    q, s = quantize_int8(x)
    y = dequantize_int8(q, s, tuple(x.shape), torch.float32)
    err = (y - x).abs().numpy()
    # per-block absmax / 127 bounds the error
    assert err.max() <= float(x.abs().max()) / 127 + 1e-6


def test_compressed_psum_error_feedback_single_device():
    g = {"w": torch.linspace(-1, 1, 256).reshape(16, 16)}
    out, err = compressed_psum(g, None, None)
    total_err = (out["w"] + err["w"].float() - g["w"]).abs().max()
    assert float(total_err) < 1e-2           # quantized + residual ≈ original


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    for s in (10, 20, 30):
        mgr.save(s, tree, extras={"next_step": s})
    assert mgr.list_steps() == [20, 30]       # gc keeps 2
    restored, extras = mgr.restore(30, tree)
    np.testing.assert_array_equal(restored["a"].numpy(),
                                  np.arange(6).reshape(2, 3))
    assert extras["next_step"] == 30


def test_checkpoint_async_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"x": torch.zeros((128, 128))}
    mgr.save(1, tree, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_trainer_resume_identical_to_uninterrupted(tmp_path, small):
    """Restart-from-checkpoint reproduces the uninterrupted run exactly:
    bitwise here (the reference's test allows atol 1e-5)."""
    pipe = _port_pipe(small.cfg.vocab)
    step_fn = make_train_step(small.cfg, small.ocfg)
    fresh = lambda: (lambda m: (m, opt.init(weights.param_tree(m),  # noqa: E731
                                            small.ocfg)))(small.model())

    t1 = Trainer(TrainerConfig(total_steps=20, ckpt_every=100,
                               ckpt_dir=str(tmp_path / "a")),
                 step_fn, pipe.batch_at)
    m_full, s_full, _ = t1.run(*fresh())

    t2 = Trainer(TrainerConfig(total_steps=10, ckpt_every=10,
                               ckpt_dir=str(tmp_path / "b"),
                               async_ckpt=False),
                 step_fn, pipe.batch_at)
    t2.run(*fresh())
    t3 = Trainer(TrainerConfig(total_steps=20, ckpt_every=100,
                               ckpt_dir=str(tmp_path / "b")),
                 step_fn, pipe.batch_at)
    m_res, s_res, rep = t3.run(*fresh())
    assert rep.resumed_from == 10
    assert rep.steps_run == 10

    for a, b in zip(m_full.parameters(), m_res.parameters()):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    for a, b in zip(jax.tree.leaves(weights.opt_state_to_reference(s_full)),
                    jax.tree.leaves(weights.opt_state_to_reference(s_res))):
        np.testing.assert_array_equal(a, b)


def test_pipeline_determinism_and_sharding():
    pipe = _port_pipe(reduced(registry.get_config("olmo-1b")).vocab, batch=8,
                      seq=32)
    b1 = pipe.batch_at(7)
    b2 = pipe.batch_at(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (8, 32)
    assert b1["tokens"].max() < pipe.cfg.vocab


def test_nan_guard_halts(tmp_path, small):
    def bad_step(m, s, batch):
        return m, s, {"loss": torch.tensor(float("nan")), "grad_norm": 0.0,
                      "lr": 0.0}

    model = small.model()
    t = Trainer(TrainerConfig(total_steps=50, max_bad_steps=3,
                              ckpt_dir=str(tmp_path)), bad_step,
                lambda s: {"tokens": np.zeros((2, 8), np.int32)})
    with pytest.raises(FloatingPointError):
        t.run(model, opt.init(weights.param_tree(model), small.ocfg))


# ---------------------------------------------------------------------------
# the port against the reference on the same numbers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,batch,seq",
                         [(0, 0, 4, 64), (0, 7, 8, 32), (3, 1, 2, 128),
                          (11, 1000, 16, 17)])
def test_batch_at_bitwise_reference(seed, step, batch, seq):
    want = _pipe(512, batch, seq, seed).batch_at(step)["tokens"]
    got = _port_pipe(512, batch, seq, seed).batch_at(step)["tokens"]
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    big = _pipe(50_304, batch, seq, seed).batch_at(step)["tokens"]
    np.testing.assert_array_equal(
        _port_pipe(50_304, batch, seq, seed).batch_at(step)["tokens"], big)


def test_schedule_matches_reference():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=110),
               dict(lr=3e-4, warmup_steps=5, total_steps=40,
                    min_lr_ratio=0.05)):
        rc, pc = r_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
        for s in (0, 1, 3, 5, 9, 10, 11, 27, 39, 40, 60, 110, 200):
            np.testing.assert_allclose(
                float(opt.schedule(pc, torch.tensor(s, dtype=torch.int32))),
                float(r_opt.schedule(rc, jnp.int32(s))), rtol=1e-6)


def test_config_fields_match_reference():
    assert [f.name for f in dataclasses.fields(opt.AdamWConfig)] == \
        [f.name for f in dataclasses.fields(r_opt.AdamWConfig)]
    assert dataclasses.asdict(opt.AdamWConfig()) == \
        dataclasses.asdict(r_opt.AdamWConfig())
    from repro.train import trainer as r_trainer
    from repro_torch.train import trainer
    for a, b in ((trainer.TrainerConfig, r_trainer.TrainerConfig),
                 (trainer.TrainerReport, r_trainer.TrainerReport)):
        assert dataclasses.asdict(a()) == dataclasses.asdict(b())
    assert opt.state_logical({"w": ("a", None)}) == \
        r_opt.state_logical({"w": ("a", None)})


APPLY_CASES = {
    # name: (config fields, params atol, params rtol, moments atol, rtol)
    "float32": ({}, 1e-6, 1e-6, 1e-6, 1e-6),
    "chunk_stacked": (dict(chunk_stacked=True), 1e-6, 1e-6, 1e-6, 1e-6),
    "bf16_moments": (dict(moment_dtype="bfloat16"), 1e-5, 0.0, 1e-8,
                     BF16_ULP),
    "bf16_math": (dict(moment_dtype="bfloat16", math_dtype="bfloat16"),
                  1e-4, 2 * BF16_ULP, 1e-4, 2 * BF16_ULP),
}


@pytest.mark.parametrize("case", list(APPLY_CASES))
def test_apply_matches_reference(ref, small, case):
    """Three ``apply`` steps on the reference's parameters and the same
    random gradients (std 0.05, clipped: their norm is ~16)."""
    kw, p_atol, p_rtol, m_atol, m_rtol = APPLY_CASES[case]
    rc = dataclasses.replace(ref.ocfg, **kw)
    pc = dataclasses.replace(small.ocfg, **kw)
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda a: (0.05 * rng.standard_normal(a.shape)
                                    ).astype(np.float32), ref.np)
    r_apply = jax.jit(lambda p, g, s: r_opt.apply(p, g, s, rc))
    rp, rs = ref.params, r_opt.init(ref.params, rc)
    model = small.model()
    params = weights.param_tree(model)
    pg = weights.params_from_reference(small.cfg, grads, "cpu")
    ps = opt.init(params, pc)
    for _ in range(3):
        rp, rs, rm = r_apply(rp, grads, rs)
        _, ps, pm = opt.apply(params, pg, ps, pc)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]), rtol=1e-6)
    assert int(ps["step"]) == int(rs["step"]) == 3
    _close(weights.params_to_reference(model), rp, p_atol, p_rtol,
           f"{case} params")
    got = weights.opt_state_to_reference(ps)
    for k in ("m", "v"):
        assert {str(x.dtype) for x in jax.tree.leaves(rs[k])} == \
            {pc.moment_dtype}
        assert {t.dtype for t in leaves(ps[k])} == \
            {getattr(torch, pc.moment_dtype)}
        _close(got[k], rs[k], m_atol, m_rtol, f"{case} {k}")


def test_reference_state_continues_in_the_port(ref, small):
    """The reference's parameters and AdamW state after two steps, carried
    across by ``weights``, take the third step in the port as in the
    reference (float32 tolerances of ``test_apply_matches_reference``);
    the port's state carried back equals the reference's step count."""
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda a: (0.05 * rng.standard_normal(a.shape)
                                     ).astype(np.float32), ref.np)
             for _ in range(3)]
    r_apply = jax.jit(lambda p, g, s: r_opt.apply(p, g, s, ref.ocfg))
    rp, rs = ref.params, r_opt.init(ref.params, ref.ocfg)
    for g in grads[:2]:
        rp, rs, _ = r_apply(rp, g, rs)
    model = weights.model_from_reference(small.cfg,
                                         jax.tree.map(np.asarray, rp), "cpu")
    state = weights.opt_state_from_reference(
        small.cfg, jax.tree.map(np.asarray, rs), "cpu")
    assert int(state["step"]) == 2 and state["step"].dtype == torch.int32
    _, state, _ = opt.apply(weights.param_tree(model),
                            weights.params_from_reference(small.cfg, grads[2],
                                                          "cpu"),
                            state, small.ocfg)
    rp, rs, _ = r_apply(rp, grads[2], rs)
    _close(weights.params_to_reference(model), rp, 1e-6, 1e-6, "params")
    back = weights.opt_state_to_reference(state)
    _close(back["m"], rs["m"], 1e-6, 1e-6, "m")
    _close(back["v"], rs["v"], 1e-6, 1e-6, "v")
    assert back["step"] == np.asarray(rs["step"]) == 3


def test_train_step_matches_reference(ref, small):
    """One step: loss, grad norm and the new parameters against the
    reference's jitted ``make_train_step``; then ten steps' losses."""
    model = small.model()
    step = make_train_step(small.cfg, small.ocfg)
    state = opt.init(weights.param_tree(model), small.ocfg)
    pipe = _port_pipe(small.cfg.vocab)
    losses = []
    for i in range(10):
        model, state, m = step(model, state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
        if i == 0:
            np.testing.assert_allclose(losses[0], ref.first.loss, rtol=1e-5)
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       ref.first.grad_norm, rtol=1e-4)
            _close(weights.params_to_reference(model), ref.first.params,
                   5e-5, 0.0, "params after one step")
            assert all(p.grad is None for p in model.parameters())
    np.testing.assert_allclose(losses, ref.losses, rtol=1e-3)


def test_microbatched_step_matches_reference(ref, small):
    model = small.model()
    step = make_microbatched_train_step(small.cfg, small.ocfg, 4)
    _, state, m = step(model, opt.init(weights.param_tree(model), small.ocfg),
                       _port_pipe(small.cfg.vocab, batch=8).batch_at(0))
    np.testing.assert_allclose(float(m["loss"]), ref.micro.loss, rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), ref.micro.grad_norm,
                               rtol=1e-4)
    _close(weights.params_to_reference(model), ref.micro.params, 5e-5, 0.0,
           "params after one microbatched step")


@pytest.mark.parametrize("shape", [(5000,), (1024,), (16, 16), (3, 700, 5),
                                   (1,)])
def test_quantize_bitwise_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * rng.uniform(1e-3, 10.0)
         ).astype(np.float32)
    x.reshape(-1)[::97] = 0.0
    rq, rs = r_gc.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    for dt, rdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = dequantize_int8(q, s, shape, dt).float().numpy()
        want = np.asarray(r_gc.dequantize_int8(rq, rs, shape, rdt),
                          np.float32)
        np.testing.assert_array_equal(got, want)


def test_compressed_psum_bitwise_reference_shard_map():
    """A world of one against the reference's one-device ``shard_map``,
    twice, the second step carrying the first's error."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.distributed.sharding import make_mesh
    mesh = make_mesh((1,), ("dp",))
    rng = np.random.default_rng(2)
    g = {"w": np.linspace(-1, 1, 256, dtype=np.float32).reshape(16, 16),
         "b": {"c": rng.standard_normal(3000).astype(np.float32)}}
    f0 = shard_map(lambda gr: r_gc.compressed_psum(gr, "dp", None),
                   mesh=mesh, in_specs=(P(),), out_specs=(P(), P()))
    f1 = shard_map(lambda gr, e: r_gc.compressed_psum(gr, "dp", e),
                   mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()))
    r_out, r_err = f0(g)
    r_out2, r_err2 = f1(g, r_err)
    tg = {"w": torch.from_numpy(g["w"]),
          "b": {"c": torch.from_numpy(g["b"]["c"])}}
    out, err = compressed_psum(tg, None, None)
    out2, err2 = compressed_psum(tg, None, err)
    for got, want in ((out, r_out), (err, r_err), (out2, r_out2),
                      (err2, r_err2)):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# checkpoints crossing between the packages
# ---------------------------------------------------------------------------

def _trained(small, moment_dtype="float32", steps=2):
    """A model and AdamW state after ``steps`` train steps (moments
    nonzero)."""
    ocfg = dataclasses.replace(small.ocfg, moment_dtype=moment_dtype)
    model = small.model()
    state = opt.init(weights.param_tree(model), ocfg)
    step = make_train_step(small.cfg, ocfg)
    pipe = _port_pipe(small.cfg.vocab, batch=2, seq=16)
    for i in range(steps):
        model, state, _ = step(model, state, pipe.batch_at(i))
    return model, state


def _reference_tree(model, state, moment_dtype="float32"):
    """The same ``(params, opt_state)`` as the reference's jnp tree."""
    mdt = jnp.dtype(moment_dtype)
    st = weights.opt_state_to_reference(state)
    return (jax.tree.map(jnp.asarray, weights.params_to_reference(model)),
            {"m": jax.tree.map(lambda a: jnp.asarray(a, mdt), st["m"]),
             "v": jax.tree.map(lambda a: jnp.asarray(a, mdt), st["v"]),
             "step": jnp.asarray(st["step"])})


def _by_key(tree):
    return dict(zip(_key_strs(tree), jax.tree.leaves(tree)))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_checkpoint_files_equal_reference(tmp_path, small, moment_dtype):
    """Both packages save the same state: the same manifest, and every
    array file byte for byte (bf16 moments included)."""
    model, state = _trained(small, moment_dtype)
    CheckpointManager(str(tmp_path / "port")).save(
        2, (weights.param_tree(model), state), extras={"next_step": 2})
    RCheckpointManager(str(tmp_path / "ref")).save(
        2, _reference_tree(model, state, moment_dtype),
        extras={"next_step": 2})
    a, b = tmp_path / "port" / "step_00000002", tmp_path / "ref" / "step_00000002"
    ma = json.loads((a / "manifest.json").read_text())
    mb = json.loads((b / "manifest.json").read_text())
    for field in ("step", "keys", "shapes", "dtypes", "extras"):
        assert ma[field] == mb[field], field
    assert (a / "manifest.json").read_bytes() == (b / "manifest.json").read_bytes()
    names = sorted(p.name for p in b.iterdir())
    assert sorted(p.name for p in a.iterdir()) == names
    assert len(names) == len(mb["keys"]) + 1
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    if moment_dtype == "bfloat16":
        assert "bfloat16" in ma["dtypes"]


def test_checkpoint_port_writes_reference_reads(tmp_path, small):
    model, state = _trained(small)
    CheckpointManager(str(tmp_path)).save(
        2, (weights.param_tree(model), state), extras={"next_step": 2})
    target = _reference_tree(small.model(), opt.init(
        weights.param_tree(small.model()), small.ocfg))
    restored, extras = RCheckpointManager(str(tmp_path)).restore(2, target)
    assert extras == {"next_step": 2}
    want = _by_key(_reference_tree(model, state))
    got = _by_key(restored)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_checkpoint_reference_writes_port_reads(tmp_path, small,
                                                moment_dtype):
    """The reference's save (bf16 moments included, which its own restore
    cannot read back: ``np.load`` gives ``V2``) restores in the port
    bitwise, leaf by key."""
    model, state = _trained(small, moment_dtype)
    tree = _reference_tree(model, state, moment_dtype)
    RCheckpointManager(str(tmp_path)).save(2, tree, extras={"next_step": 2})
    fresh = small.model()
    ocfg = dataclasses.replace(small.ocfg, moment_dtype=moment_dtype)
    (params, st), extras = CheckpointManager(str(tmp_path)).restore(
        2, (weights.param_tree(fresh), opt.init(weights.param_tree(fresh),
                                                ocfg)))
    assert extras == {"next_step": 2}
    assert st["m"]["embed"].dtype == getattr(torch, moment_dtype)
    want = _by_key(tree)
    got = {f"0/{k}": v for k, v in _by_key(weights.tree_to_reference(
        params)).items()}
    got.update({f"1/{k}": v for k, v in _by_key(
        weights.opt_state_to_reference(st)).items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                      np.asarray(want[k], np.float32),
                                      err_msg=k)


def test_checkpoint_async_snapshot_survives_in_place_update(tmp_path, small):
    """An async save followed at once by an in-place optimizer step still
    stores the saved step's values."""
    model, state = _trained(small, steps=1)
    tree = (weights.param_tree(model), state)
    before = [t.detach().clone() for t in jax.tree.leaves(tree)]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree, blocking=False)
    step = make_train_step(small.cfg, small.ocfg)
    step(model, state, _port_pipe(small.cfg.vocab, batch=2, seq=16).batch_at(1))
    mgr.wait()
    after = [t.detach() for t in jax.tree.leaves(tree)]
    assert any(not torch.equal(a, b) for a, b in zip(before, after))
    (params, st), _ = mgr.restore(1, tree)
    for a, b in zip(jax.tree.leaves((params, st)), before):
        assert torch.equal(a, b)


def test_checkpoint_restore_checks_keys_and_sharding(tmp_path, small):
    """Restored with ``launch.train``'s ``sharding_fn`` on a one-rank gloo
    group's (1, 1) mesh, every leaf is a DTensor of its placements whose
    whole tensor is the saved one, bitwise; without a mesh in the rules the
    ``sharding_fn`` has nowhere to place; mismatched keys raise."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import (DEFAULT_RULES,
                                                  logical_rules, named_mesh,
                                                  shardings_for)
    model, state = _trained(small, steps=1)
    mgr = CheckpointManager(str(tmp_path))
    tree = (weights.param_tree(model), state)
    mgr.save(1, tree)
    logical = weights.logical_names(small.cfg)

    def sharding_fn(t):
        return shardings_for(t, (logical, opt.state_logical(logical)))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = named_mesh((1, 1), ("data", "model"), "cpu")
        with logical_rules(mesh, DEFAULT_RULES):
            placed, _ = mgr.restore(1, tree, sharding_fn=sharding_fn)
            want = sharding_fn(tree)
        got_l, want_l = jax.tree.leaves(placed), jax.tree.leaves(tree)
        pls = jax.tree.leaves(want, is_leaf=lambda x: isinstance(
            x, tuple) and all(hasattr(p, "is_shard") for p in x))
        assert len(got_l) == len(want_l) == len(pls)
        for g, w, p in zip(got_l, want_l, pls):
            assert tuple(g.placements) == p
            assert torch.equal(g.full_tensor(), w)
        with pytest.raises(ValueError, match="DeviceMesh"):
            mgr.restore(1, tree, sharding_fn=sharding_fn)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, (weights.param_tree(model),))
    # the same number of leaves under other keys (m and v's trees swapped
    # for the parameters' would load in the reference without a word)
    params = weights.param_tree(model)
    renamed = dict(params, embed_=params.pop("embed"))
    with pytest.raises(ValueError, match="embed"):
        mgr.restore(1, (renamed, state))


_CHILD = r"""
import json, os, signal, sys
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.configs.base import reduced
from repro_torch.models import registry, transformer as tfm, weights
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
cfg = reduced(registry.get_config("olmo-1b"))
pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=16,
                                         global_batch=2))
ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
def data_fn(step):
    if step == int(sys.argv[2]):
        os.kill(os.getpid(), signal.SIGTERM)      # preemption, to itself
    return pipe.batch_at(step)
out = []
for total in (50, 6):
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    t = Trainer(TrainerConfig(total_steps=total, ckpt_every=100,
                              ckpt_dir=sys.argv[1]), make_train_step(cfg, ocfg),
                data_fn)
    _, st, rep = t.run(model, opt.init(weights.param_tree(model), ocfg))
    out.append(dict(interrupted=rep.interrupted, steps_run=rep.steps_run,
                    resumed_from=rep.resumed_from, step=int(st["step"]),
                    latest=t.ckpt.latest_step(),
                    handler=signal.getsignal(signal.SIGTERM) == signal.SIG_DFL))
print(json.dumps(out))
"""


def test_trainer_sigterm_saves_and_resumes(tmp_path):
    """SIGTERM mid-run (a child process sends it to itself while the data
    of step 3 is drawn): the step finishes, a blocking checkpoint of
    ``next_step`` 4 is written, the handlers are restored; a new trainer
    resumes there."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path), "3"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first, second = json.loads(out.stdout.strip().splitlines()[-1])
    assert first == dict(interrupted=True, steps_run=4, resumed_from=None,
                         step=4, latest=4, handler=True)
    assert second == dict(interrupted=False, steps_run=2, resumed_from=4,
                          step=6, latest=4, handler=True)
