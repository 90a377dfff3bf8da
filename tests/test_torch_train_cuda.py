"""The training substrate and entry points on the card: one ``100m``
train step against the same step on the CPU, a checkpoint written from
the card and restored on the CPU, and ``launch.train.main`` on the card.
Imports no ``jax``, so it runs where the card is::

    python -m pytest -q -m cuda tests/test_torch_train_cuda.py

everywhere else every case skips with a reason.

Tolerances (TF32 off, float32): the loss within rtol 1e-5; the
gradients within 2e-2 of their norm and the grad norm within rtol 1e-2 —
the reference's arithmetic rounds attention probabilities and their
cotangents to bf16 even in float32, so a float32 rounding of a logit
moves a gradient by a bf16 ulp (on the CPU alone the 100m gradient moves
3.4e-3 of its norm between 1 and 4 threads, and 5.8e-3 when the
embedding is scaled by one ulp); after the step, 99% of the parameters
within atol 5e-5 (measured on an H100: 99.59%; 99.96% between 1 and 4
CPU threads) and all within twice step 1's learning rate (AdamW's first
update is ``lr · g / (|g| + eps)``, a sign on all but near-zero
gradients, which flip with the rounding); the checkpoint bitwise.
"""
import copy

import numpy as np
import pytest
import torch

from _torch_port import cuda, torch_threads  # noqa: F401
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import registry, transformer as tfm
from repro_torch.models.common import leaves
from repro_torch.models.weights import param_tree
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import make_train_step

pytestmark = pytest.mark.cuda
OCFG = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)


def _pair(cfg):
    """The same seed-0 model on the CPU and the card."""
    cpu = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cpu, copy.deepcopy(cpu).to("cuda")


def test_100m_step_on_the_card_matches_the_cpu(cuda):
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = launch_train.preset_config("olmo-1b", "100m")
    batch = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=128, global_batch=2)).batch_at(0)
    step = make_train_step(cfg, OCFG)
    out = {}
    for name, model in zip(("cpu", "cuda"), _pair(cfg)):
        registry.loss_fn(model, {"tokens": torch.as_tensor(
            batch["tokens"]).to(model.embed.device)}).backward()
        grads = torch.cat([g.cpu().reshape(-1) for g in
                           leaves(param_tree(model, grads=True))])
        model, state, m = step(model, opt.init(param_tree(model), OCFG),
                               batch)
        params = torch.cat([p.detach().cpu().reshape(-1)
                            for p in leaves(param_tree(model))])
        out[name] = (float(m["loss"]), float(m["grad_norm"]), grads, params,
                     state)
    (l0, g0, d0, p0, _), (l1, g1, d1, p1, s1) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    np.testing.assert_allclose(g1, g0, rtol=1e-2)
    assert float((d1 - d0).norm() / d0.norm()) <= 2e-2
    lr1 = float(opt.schedule(OCFG, 1))
    diff = (p1 - p0).abs()
    assert float(diff.max()) <= 2 * lr1 + 1e-6
    assert float((diff <= 5e-5).float().mean()) >= 0.99
    assert s1["m"]["embed"].is_cuda and int(s1["step"]) == 1


def test_checkpoint_from_the_card_restores_on_the_cpu_bitwise(cuda, tmp_path):
    cfg = launch_train.preset_config("olmo-1b", "smoke")
    cpu, card = _pair(cfg)
    state = opt.init(param_tree(card), OCFG)
    card, state, _ = make_train_step(cfg, OCFG)(
        card, state, TokenPipeline(TokenPipelineConfig(
            vocab=cfg.vocab, seq_len=16, global_batch=2)).batch_at(0))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, (param_tree(card), state), blocking=False)
    mgr.wait()
    (params, st), _ = mgr.restore(
        1, (param_tree(cpu), opt.init(param_tree(cpu), OCFG)))
    for a, b in zip(leaves([params, st]), leaves([param_tree(card), state])):
        assert a.device.type == "cpu"
        assert torch.equal(a, b.detach().cpu())


def test_train_main_on_the_card(cuda, tmp_path, capsys):
    argv = ["--steps", "6", "--batch", "2", "--seq", "32", "--ckpt-every",
            "3", "--ckpt-dir", str(tmp_path)]
    launch_train.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=olmo-1b preset=smoke params=0.1M mesh=")
    assert out[-1].startswith("done: steps=6 ") and "resumed_from=None" in out[-1]
    launch_train.main(argv[:1] + ["9"] + argv[2:])
    assert "resumed_from=6" in capsys.readouterr().out.splitlines()[-1]
