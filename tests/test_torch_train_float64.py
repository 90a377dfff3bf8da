"""The dense transformer's training step in float64: a check instrument
that a placed step is held to, since a correct placement agrees with one
process to about 1e-12 in float64 whatever the conditioning, and a term
lost, doubled or scaled on a shard does not.

``models.common.work_dtype`` gives the dtype of the reference's float32
arithmetic (norms, positions, the attention's query, carry and chunks, the
loss): float64 for a float64 operand, float32 otherwise.  The step is
built as ``scripts/train_over_cards.py`` builds it: the config with
``param_dtype`` and ``compute_dtype`` ``"float64"``, the parameters cast,
the attention's bf16 roundings the identity.  Bounds (measured here in
brackets):

* on four gloo ranks (``tests/_torch_mesh_children.py``'s ``float64``
  job) the placed float64 first step on (2, 2), (1, 4) and (4, 1), of
  reduced OLMo-1B on 4 x 32 (``smoke``) and of a wider one (d_model 256,
  two layers, 8 x 64, the ``full`` preset's remat and sequence-sharded
  residual), against one process's: the loss within 1e-12 relative, every
  gradient leaf within 1e-10 by both of the script's measures [smoke
  1.3e-15, wide 1.9e-12];
* a census of every op (a ``TorchDispatchMode``) in the float64 step,
  forward and backward, plain and placed: no floating output other than
  float64;
* the float64 step with the bf16 roundings in place against the
  reference's float32 step on its own parameters: loss rtol 1e-5, every
  leaf within 1e-4, the float32 port's bound
  (``tests/test_torch_train_mesh.py``) [1.3e-5];
* float32 and bf16 configurations: the train step's loss and gradients,
  prefill's logits and caches and a decode step's logits bitwise what the
  code before ``work_dtype`` gave, its functions kept here as twins.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from _torch_port import torch_threads  # noqa: F401
from _torch_mesh_children import (CASES64, SHAPES, census, flat,
                                  float64_model, script)
from repro.configs.base import reduced as r_reduced
from repro.data.tokens import TokenPipeline as RPipeline
from repro.data.tokens import TokenPipelineConfig as RPipelineConfig
from repro.models import registry as r_registry
from repro.models import transformer as r_tfm
from repro_torch.configs.base import reduced
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.distributed.sharding import get_device_mesh, shard
from repro_torch.models import (common, griffin, moe, registry, transformer,
                                weights, xlstm)
from repro_torch.models.common import map_tree
from repro_torch.train import train_step as ts

ROOT = Path(__file__).resolve().parents[1]
CHILD = str(ROOT / "tests" / "_torch_mesh_children.py")
TIMEOUT = 300
LOSS_TOL, GRAD_TOL = 1e-12, 1e-10

pytestmark = pytest.mark.usefixtures("torch_threads")


toc = script()


def _unrounded(monkeypatch):
    monkeypatch.setattr(common, "_RoundBF16", toc.Unrounded)
    monkeypatch.setattr(common, "_GradRoundBF16", toc.Unrounded)


def _step(model, batch) -> tuple[float, dict]:
    """One process's first step: the loss and the gradients by the
    reference's keys, as numpy."""
    loss, grads = ts._loss_and_grads(model, ts._model_batch(model, batch))
    return float(loss), flat(weights.tree_to_reference(grads))


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    """The ``float64`` job on four gloo ranks: its report and the folder
    of each case and mesh's ``.npz``."""
    out = tmp_path_factory.mktemp("float64")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, CHILD, "float64", str(r), "4", str(out / "store"),
         str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    reports = []
    for p in procs:
        o, e = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, e[-3000:]
        reports.append(json.loads(o.strip().splitlines()[-1]))
    return reports, out


@pytest.fixture(scope="module")
def one_process():
    """Each case's float64 first step in this process (the bf16 roundings
    the identity)."""
    mp = pytest.MonkeyPatch()
    _unrounded(mp)
    try:
        return {case: _step(*float64_model(case)) for case in CASES64}
    finally:
        mp.undo()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(CASES64))
def test_placed_float64_step_matches_one_process(placed, one_process, case,
                                                 shape):
    reports, out = placed
    name = f"{case}_{shape[0]}x{shape[1]}"
    for rep in reports:
        assert rep[name] == {"census": {}, "ops": rep[name]["ops"],
                             "dtype": "torch.float64"}, rep[name]
        assert rep[name]["ops"] > 100
    got = dict(np.load(out / f"{name}.npz"))
    loss = float(got.pop("loss"))
    want_loss, want = one_process[case]
    assert all(v.dtype == np.float64 for v in got.values())
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss), (loss,
                                                                want_loss)
    rows = toc.measures(got, want)
    assert [k for _, _, k in rows] and sorted(got) == sorted(want)
    assert toc.worst(rows) <= GRAD_TOL, rows[:3]


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-32b", "whisper-base"])
def test_float64_step_census(arch, monkeypatch):
    """Every floating op of the plain float64 step, forward and backward,
    outputs float64: OLMo's LayerNorm and rotary positions, Qwen3's
    RMSNorm on queries and keys and its grouped heads, Whisper's
    sinusoidal positions, encoder and cross-attention."""
    _unrounded(monkeypatch)
    cfg = reduced(registry.get_config(arch), param_dtype="float64",
                  compute_dtype="float64", remat="full")
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    batch = ts._model_batch(model, _batch(cfg, 4, 32))    # frames float32
    with census() as seen:
        loss, grads = ts._loss_and_grads(model, batch)
    assert seen.found == {} and seen.ops > 100, seen.found
    assert all(g.dtype == torch.float64 for g in common.leaves(grads))
    assert math.isfinite(float(loss))


def test_float64_step_computes_the_reference_function():
    """With its bf16 roundings in place, the float64 step on the
    reference's parameters against the reference's float32 step."""
    rcfg = r_reduced(r_registry.get_config("olmo-1b"))
    tree = jax.tree.map(np.asarray, r_tfm.init_params(
        rcfg, jax.random.PRNGKey(0)))
    batch = RPipeline(RPipelineConfig(vocab=rcfg.vocab, seq_len=32,
                                      global_batch=4)).batch_at(0)
    loss, grads = jax.value_and_grad(
        lambda p, b: r_registry.loss_fn(p, b, rcfg))(tree, batch)
    want = flat(jax.tree.map(np.asarray, grads))
    cfg = reduced(registry.get_config("olmo-1b"), param_dtype="float64",
                  compute_dtype="float64")
    model = weights.model_from_reference(
        cfg, map_tree(lambda a: a.astype(np.float64), tree), "cpu")
    got_loss, got = _step(model, batch)
    assert abs(got_loss - float(loss)) <= 1e-5 * abs(float(loss))
    assert toc.worst(toc.measures(got, want)) <= 1e-4


# ---------------------------------------------------------------------------
# float32 and bf16 configurations: bitwise the code before work_dtype
# ---------------------------------------------------------------------------

def _batch(cfg, b: int, s: int) -> dict:
    batch = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b)).batch_at(0)
    rng = np.random.default_rng(0)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


class Before:
    """The functions ``work_dtype`` changed, as they were: float32 by
    hand."""

    @staticmethod
    def rms_norm(x, scale, eps=1e-6):
        if not common.untracked(x, scale):
            return checkpoint(Before._rms_norm, x, scale, eps,
                              use_reentrant=False, preserve_rng_state=False)
        x32 = x.float()
        r = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
        y = x32.mul_(r) if x32 is not x else x32 * r
        if scale is not None:
            y.mul_(1.0 + scale.float())
        return y.to(x.dtype)

    @staticmethod
    def _rms_norm(x, scale, eps: float):
        x32 = x.float()
        y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
        if scale is not None:
            y = y * (1.0 + scale.float())
        return y.to(x.dtype)

    @staticmethod
    def layer_norm_nonparam(x, eps=1e-5):
        if not common.untracked(x):
            return checkpoint(Before._layer_norm_nonparam, x, eps,
                              use_reentrant=False, preserve_rng_state=False)
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        c = x32.sub_(mu) if x32 is not x else x32 - mu
        var = (c ** 2).mean(-1, keepdim=True)
        return c.mul_(torch.rsqrt(var + eps)).to(x.dtype)

    @staticmethod
    def _layer_norm_nonparam(x, eps: float):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)

    @staticmethod
    def rope(x, pos, theta):
        half = x.shape[-1] // 2
        exps = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
        freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=x.device), exps)
        ang = pos[..., None].float() * freqs
        cos = torch.cos(ang)[None, :, None, :]
        sin = torch.sin(ang)[None, :, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
        return out.to(x.dtype)

    @staticmethod
    def sinusoidal_at(pos, d):
        dim = torch.arange(d // 2, dtype=torch.float32,
                           device=pos.device)[None, :]
        ang = pos.float()[:, None] / (10_000.0 ** (2 * dim / d))
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

    @staticmethod
    def sinusoidal(seq, d, device=None, *_):   # the dtype it did not take
        return Before.sinusoidal_at(torch.arange(seq, dtype=torch.float32,
                                                 device=device), d)

    class _RoundBF16(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.to(torch.bfloat16).float()

        @staticmethod
        def backward(ctx, g):
            return g

    class _GradRoundBF16(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g.to(torch.bfloat16).float()

    @staticmethod
    def _attention_core(q, k, v, *, causal, window, chunk):
        b, sq, h, d = q.shape
        scale = 1.0 / math.sqrt(d)
        chunk = min(chunk, k.shape[1])
        qf = (q.float() * scale).to(k.dtype).float()
        if not common.untracked(q, k, v):
            _, l, acc = common._ChunkedAttention.apply(qf, k, v, causal,
                                                       window, chunk)
        else:
            m, l, acc = Before._attention_init(qf)
            for lo in range(0, k.shape[1], chunk):
                m, l, acc = Before._attention_chunk_inplace(
                    qf, k[:, lo:lo + chunk], v[:, lo:lo + chunk], m, l, acc,
                    lo, causal, window)
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def _attention_init(qf):
        b, sq, h, d = qf.shape
        return (torch.full((b, h, sq), -math.inf, dtype=torch.float32,
                           device=qf.device),
                torch.zeros((b, h, sq), dtype=torch.float32,
                            device=qf.device),
                torch.zeros((b, h, sq, d), dtype=torch.float32,
                            device=qf.device))

    @staticmethod
    def _attention_chunk(qf, kb, vb, m, l, acc, lo, causal, window):
        kb, vb = kb.float(), vb.float()
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        logits = shard(logits, "batch", "heads", None, None)
        mask = common._chunk_mask(qf.shape[1], lo, kb.shape[1], causal,
                                  window, qf.device)
        logits = torch.where(mask[None, None], logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        p = Before._RoundBF16.apply(torch.exp(logits - m_new[..., None]))
        corr = torch.exp(m - m_new)
        l = l * corr + Before._GradRoundBF16.apply(p).sum(-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", Before._GradRoundBF16.apply(p),
                          vb)
        acc = acc * corr[..., None] + pv
        return m_new, l, acc

    @staticmethod
    def _attention_chunk_inplace(qf, kb, vb, m, l, acc, lo, causal, window):
        kb, vb = kb.float(), vb.float()
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        logits = shard(logits, "batch", "heads", None, None)
        mask = common._chunk_mask(qf.shape[1], lo, kb.shape[1], causal,
                                  window, qf.device)
        logits.masked_fill_(~mask[None, None], -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        p = logits.sub_(m_new[..., None]).exp_().to(torch.bfloat16)
        del logits
        p = p.float()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p, vb)
        del p
        acc.mul_(corr[..., None]).add_(pv)
        return m_new, l, acc

    @staticmethod
    def loss_fn(model, batch):
        logits = transformer.forward_train(model, batch).float()
        targets = batch["tokens"][:, 1:].long()
        if get_device_mesh() is not None:
            return registry._loss_on_mesh(logits, targets)
        logits = logits[:, :-1, :]
        lse = registry._LogSumExp.apply(logits)
        picked = torch.gather(logits, -1, targets[..., None])[..., 0]
        return (lse - picked).mean()


def _as_before(monkeypatch) -> None:
    """Every module's binding of a function ``work_dtype`` changed set to
    its :class:`Before` form."""
    names = [k for k in vars(Before) if not k.startswith("__")]
    assert all(k in vars(common) for k in names if k != "loss_fn")
    for mod in (common, transformer, griffin, xlstm, moe, registry, ts):
        for name in names:
            if name in vars(mod):
                monkeypatch.setattr(mod, name, getattr(Before, name))


def _everything(cfg) -> dict:
    """The train step's loss and gradients, prefill's logits and caches
    and one decode step's logits on fixed weights and batch."""
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    batch = _batch(cfg, 2, 24)
    loss, grads = _step(model, batch)
    out = dict(grads, loss=np.float64(loss))
    with torch.no_grad():
        tb = ts._model_batch(model, batch)
        logits, cache = transformer.forward_prefill(model, tb)
        cache = transformer.grow_cache(cache, 24, 25)
        nxt, _ = transformer.forward_decode(
            model, cache, logits.argmax(-1).to(torch.int32), 24)
    out.update(prefill=logits.float().numpy(), decode=nxt.float().numpy(),
               **{f"cache{k}": v.float().numpy()
                  for k, v in toc.named(cache)})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-32b", "whisper-base",
                                  "recurrentgemma-9b"])
def test_float32_and_bf16_steps_bitwise_as_before(arch, dtype, monkeypatch):
    cfg = reduced(registry.get_config(arch), compute_dtype=dtype)
    now = _everything(cfg)
    _as_before(monkeypatch)
    before = _everything(cfg)
    assert sorted(now) == sorted(before)
    for k in before:
        np.testing.assert_array_equal(now[k], before[k], err_msg=k)
