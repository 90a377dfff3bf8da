"""The port's LM programs against the reference's own memory plan, and the
repairs that bring them to it.

* Peaks: each reduced config's train and prefill step on a (4, 2) mesh,
  counted by the port's dry run (``op_cost``), within ``REDUCED_FACTOR``
  of the reference's ``memory_analysis`` of the same compiled step (the
  largest ratio measured is 1.34, llama3-405b's train step); OLMo-1B's and
  RecurrentGemma-9B's prefill_32k on the 16 x 16 production mesh within
  ``PROD_FACTOR`` (measured 0.98 and 1.24).  Each side runs in a child
  process (``tests/_torch_dryrun_children.py``): the reference needs its
  device count before JAX starts, the port's fake process group must not
  outlive its job.
* Loops by trip: a reduced xLSTM's train and prefill steps counted one
  trip a loop (``models.common.scan`` under ``op_cost.scaled``, the
  backward included) equal the same steps run trip by trip
  (``op_cost.unrolled``) in FLOPs, HBM bytes and aten ops.
* Repairs, each against its form before them (kept here as twins):
  attention's chunk loop, the norms, the xLSTM loops, the logsumexp of the
  loss and Griffin's gates and scan give bitwise equal outputs, and
  bitwise equal gradients, except the scan, which has its own backward:
  its gradients are held within 1e-5 (relative to each leaf's largest
  magnitude) of autograd through its twin, and within 1e-4 of ``jax.grad``
  of the reference's ``rglru_apply``.
"""
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CHILD = ROOT / "tests" / "_torch_dryrun_children.py"
ARCHS = ("whisper-base", "llama4-scout-17b-a16e", "phi3.5-moe-42b-a6.6b",
         "mistral-nemo-12b", "llama3-405b", "olmo-1b", "qwen3-32b",
         "xlstm-1.3b", "recurrentgemma-9b", "llama-3.2-vision-90b")
REDUCED_FACTOR = 1.4
PROD_FACTOR = 1.5
PROD_CELLS = "olmo-1b:prefill_32k,recurrentgemma-9b:prefill_32k"
SCAN_GRAD_TWIN, SCAN_GRAD_REF = 1e-5, 1e-4


def _children(*jobs: tuple[str, ...]) -> list[dict]:
    """Each job in its own child process, all at once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, str(CHILD), *job], env=env,
                              cwd=str(ROOT), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for job in jobs]
    out = []
    for p in procs:
        so, se = p.communicate(timeout=600)
        assert p.returncode == 0, se[-3000:]
        out.append(json.loads(so.strip().splitlines()[-1]))
    return out


@pytest.fixture(scope="module")
def peaks():
    ref, train, prefill, ref_prod, port_prod = _children(
        ("ref", "peaks"), ("port", "peaks", "train"),
        ("port", "peaks", "prefill"), ("ref", "prod", PROD_CELLS),
        ("port", "prod", PROD_CELLS))
    return ref, {**train, **prefill}, ref_prod, port_prod


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_peak_near_the_reference(peaks, arch, kind):
    ref, port = peaks[0][f"{arch}|{kind}"], peaks[1][f"{arch}|{kind}"]
    assert port["argument_bytes"] == ref["argument_bytes"]
    assert port["peak_per_device"] <= REDUCED_FACTOR * ref["peak_per_device"]


@pytest.mark.parametrize("cell", PROD_CELLS.split(","))
def test_production_prefill_peak_near_the_reference(peaks, cell):
    ref, port = peaks[2][cell], peaks[3][cell]
    assert port["argument_bytes"] == ref["argument_bytes"]
    assert port["peak_per_device"] <= PROD_FACTOR * ref["peak_per_device"]
    assert port["peak_per_device"] >= ref["peak_per_device"] / PROD_FACTOR


# ---------------------------------------------------------------------------
# loops counted by trip
# ---------------------------------------------------------------------------

# reduced xLSTM at 2 x 64 with mLSTM chunks of 16: four chunks a block
XL_B, XL_S, XL_CHUNK = 2, 64, 16


@pytest.fixture
def xlstm_chunk(monkeypatch):
    from repro_torch.models import xlstm
    monkeypatch.setattr(xlstm, "MLSTM_CHUNK", XL_CHUNK)


def _count(cfg, kind: str, unrolled: bool):
    from repro_torch.configs.base import RunShape
    from repro_torch.distributed import op_cost, sharding
    from repro_torch.launch import dryrun
    shape = RunShape("t", XL_S, XL_B, kind)
    with sharding.fake_world(1):
        mesh = sharding.named_mesh((1, 1), ("data", "model"), "cpu")
        rules = dryrun.rules_for(cfg, shape, mesh)
        step, args = dryrun.cell_program(cfg, shape, mesh, rules, "cpu")

        def run(*a):
            if not unrolled:
                return step(*a)
            with op_cost.unrolled():
                return step(*a)
        with dryrun.traced(mesh, rules):
            return op_cost.analyze(run, *args)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_xlstm_counted_by_trip_equals_unrolled(kind, xlstm_chunk):
    from repro_torch.configs.base import reduced
    from repro_torch.models import registry
    cfg = reduced(registry.get_config("xlstm-1.3b"))
    counted, unrolled = _count(cfg, kind, False), _count(cfg, kind, True)
    assert counted.flops == unrolled.flops > 0
    assert counted.flops_by_dtype == unrolled.flops_by_dtype
    assert counted.hbm_bytes == unrolled.hbm_bytes
    assert counted.hbm_bytes_hi == unrolled.hbm_bytes_hi
    assert counted.aten_ops == unrolled.aten_ops
    # 7 mLSTM blocks of 4 chunks, one sLSTM block of 64 steps; the
    # backward walks the same trips
    want = {"mlstm.chunks": 7 * XL_S // XL_CHUNK, "slstm.steps": XL_S}
    if kind == "train":
        want.update({f"{k}.backward": v for k, v in want.items()})
    assert counted.loops == want and unrolled.loops == {}
    # one trip's carries held instead of every trip's (a few KB here)
    assert abs(counted.peak_bytes - unrolled.peak_bytes) <= \
        0.01 * unrolled.peak_bytes


def test_xlstm_counted_flops_equal_flop_counter_over_the_real_step(
        xlstm_chunk):
    """The dry run's 1 x 1 train step of a reduced xLSTM, its loops counted
    one trip each, against ``FlopCounterMode`` over the plain step run
    trip by trip on real tensors: the backward is counted by trip too."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import reduced
    from repro_torch.launch import dryrun
    from repro_torch.models import registry, transformer as tfm
    from repro_torch.models.weights import param_tree
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    cfg = reduced(registry.get_config("xlstm-1.3b"))
    counted = _count(cfg, "train", False)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ocfg = dryrun.adamw_for(cfg)
    state = opt.init(param_tree(model), ocfg)
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (XL_B, XL_S),
        generator=torch.Generator().manual_seed(1), dtype=torch.int32)}
    with FlopCounterMode(display=False) as fc:
        make_train_step(cfg, ocfg)(model, state, batch)
    assert counted.flops == fc.get_total_flops()


def test_scan_runs_every_trip_outside_a_count():
    from repro_torch.models.common import scan
    trips = []

    def step(carry, xs, consts):
        trips.append(1)
        (c,) = carry
        c = c * consts[0] + xs[0][:, 0]
        return (c,), c[:, None] * 2
    x = torch.arange(12.0).reshape(2, 6, 1)
    ys, (c,) = scan("t", step, 1, (torch.zeros(2, 1),), (x,),
                    (torch.tensor(0.5),), (2, 6, 1), torch.float32)
    want, acc = [], torch.zeros(2, 1)
    for t in range(6):
        acc = acc * 0.5 + x[:, t]
        want.append(acc * 2)
    assert len(trips) == 6
    assert torch.equal(ys, torch.stack(want, 1)) and torch.equal(c, acc)


def test_peak_sites_name_the_storage_at_the_peak():
    """``sites=True`` groups the live storages at the peak by aten op and
    the package function that ran it (``"?"`` outside the package)."""
    from repro_torch.distributed import op_cost
    from repro_torch.models.common import rms_norm
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a = torch.empty(256, 256)

    def fn(a):
        y = rms_norm(a.repeat(4, 1), None)             # 1 MiB, and its copy
        return (y @ a.repeat(1, 2)).sum()              # 2 MiB
    c = op_cost.analyze(fn, a, sites=True)
    mib = 2 ** 20
    assert c.peak_sites[0] == {"op": "mm", "site": "?", "bytes": 2 * mib}
    assert {"op": "mul", "site": "models.common.rms_norm",
            "bytes": mib} in c.peak_sites
    assert {"op": "argument", "site": "", "bytes": mib // 4} in c.peak_sites
    assert sum(e["bytes"] for e in c.peak_sites) == c.peak_bytes
    assert op_cost.analyze(fn, a).peak_sites == []


# ---------------------------------------------------------------------------
# the repaired functions against their forms before the repairs
# ---------------------------------------------------------------------------

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


def twin_attention_core(q, k, v, *, causal, window, chunk):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    chunk = min(chunk, sk)
    n_chunks = -(-sk // chunk)
    qf = (q.float() * scale).to(k.dtype).float()
    qpos = torch.arange(sq)
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32)
    l = torch.zeros((b, h, sq), dtype=torch.float32)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32)
    for ci in range(n_chunks):
        lo = ci * chunk
        kb = k[:, lo:lo + chunk].float()
        vb = v[:, lo:lo + chunk].float()
        kpos = lo + torch.arange(kb.shape[1])
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        mask = torch.ones((sq, kb.shape[1]), dtype=torch.bool)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window:
            mask &= qpos[:, None] - kpos[None, :] < window
        logits = torch.where(mask[None, None], logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        p = _RoundBF16.apply(torch.exp(logits - m_new[..., None]))
        corr = torch.exp(m - m_new)
        l = l * corr + _GradRoundBF16.apply(p).sum(-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", _GradRoundBF16.apply(p), vb)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def twin_rms_norm(x, scale, eps=1e-6):
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(x.dtype)


def twin_layer_norm_nonparam(x, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def twin_linear_scan(a, b):
    S = a.shape[1]
    off = 1
    while off < S:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        b = torch.cat([b[:, :off], a[:, off:] * b_prev + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a_prev], dim=1)
        off *= 2
    return b


def twin_gates(p, xr):
    from repro_torch.models.griffin import RGLRU_C
    dtype = xr.dtype
    rgate = torch.sigmoid((xr @ p.w_a.to(dtype)).float())
    igate = torch.sigmoid((xr @ p.w_x.to(dtype)).float())
    log_a0 = F.logsigmoid(p.lam.float())
    log_a = RGLRU_C * rgate * log_a0[None, None, :]
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-9)) * igate * xr.float()
    return a, b


def twin_mlstm_apply(p, x, cfg, state):
    from repro_torch.models.common import rms_norm
    from repro_torch.models.xlstm import MLSTM_CHUNK, _mlstm_qkvif
    dtype = x.dtype
    B, S, D = x.shape
    nh = cfg.n_heads
    dh = D // nh
    h = rms_norm(x, p.norm)
    q, k, v, ig, fg, z = _mlstm_qkvif(p, h, cfg)
    L = min(MLSTM_CHUNK, S)
    q, k, v = q.float(), k.float(), v.float()
    C = torch.zeros((B, nh, dh, dh), dtype=torch.float32)
    n = torch.zeros((B, nh, dh), dtype=torch.float32)
    if state is not None:
        C = C + state["C"].float()
        n = n + state["n"].float()
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool))
    ones = torch.ones((B, L, nh), dtype=torch.float32)
    hs = []
    for c0 in range(0, S, L):
        qb, kb, vb = q[:, c0:c0 + L], k[:, c0:c0 + L], v[:, c0:c0 + L]
        ib, fb = ig[:, c0:c0 + L], fg[:, c0:c0 + L]
        cl = torch.cumsum(torch.log(fb), dim=1)
        dstart = torch.exp(cl)
        h_inter = torch.einsum("blhd,bhde->blhe", qb * dstart[..., None], C)
        qk = torch.einsum("blhd,bmhd->bhlm", qb, kb)
        expo = cl[:, :, None, :] - cl[:, None, :, :]
        expo = torch.where(causal[None, :, :, None], expo, -30.0)
        gate = torch.exp(expo) * ib[:, None, :, :]
        gate = torch.where(causal[None, :, :, None], gate, 0.0)
        sc = qk * gate.permute(0, 3, 1, 2)
        h_intra = torch.einsum("bhlm,bmhd->blhd", sc, vb)
        n_inter = torch.einsum("blhd,bhd->blh", qb * dstart[..., None], n)
        n_intra = torch.einsum("bhlm,bmh->blh", sc, ones)
        denom = torch.clamp_min(torch.abs(n_inter + n_intra), 1.0)[..., None]
        hs.append((h_inter + h_intra) / denom)
        dtail = torch.exp(cl[:, -1:, :] - cl)
        kw = kb * (dtail * ib)[..., None]
        decay = torch.exp(cl[:, -1, :])
        C = C * decay[:, :, None, None] + torch.einsum("blhd,blhe->bhde",
                                                       kw, vb)
        n = n * decay[:, :, None] + kw.sum(dim=1)
    hs = torch.cat(hs, dim=1).reshape(B, S, D)
    hs = rms_norm(hs.to(dtype), p.out_norm)
    y = hs * F.silu(z)
    out = y @ p.w_down.to(dtype)
    return x + out, {"C": C, "n": n}


def twin_slstm_apply(p, x, cfg, state):
    from repro_torch.models.common import rms_norm
    from repro_torch.models.xlstm import _slstm_cell
    dtype = x.dtype
    B, S, D = x.shape
    nh = cfg.n_heads
    dh = D // nh
    xi = rms_norm(x, p.norm)
    gx = (xi @ p.w_g.to(dtype)).reshape(B, S, nh, 4 * dh).float()
    r_g = p.r_g.float()
    if state is not None:
        h, c, n = (state[key].float() for key in ("h", "c", "n"))
    else:
        h = torch.zeros((B, nh, dh), dtype=torch.float32)
        c, n = torch.zeros_like(h), torch.zeros_like(h)
    hs = []
    for t in range(S):
        h, c, n = _slstm_cell(gx[:, t], h, c, n, r_g)
        hs.append(h)
    hs = torch.stack(hs, dim=1).reshape(B, S, D).to(dtype)
    hs = rms_norm(hs, p.out_norm)
    out = hs @ p.w_down.to(dtype)
    return x + out, {"h": h, "c": c, "n": n}


def twin_loss(logits, targets):
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - picked).mean()


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [t]


def _run_both(fn, twin, inputs: dict, grad: bool):
    """``fn`` and ``twin`` on copies of ``inputs`` (name → tensor): the
    outputs, and with ``grad`` the gradients of a fixed random projection
    of every floating output leaf with respect to every input."""
    res = []
    for f in (fn, twin):
        ins = {k: v.detach().clone().requires_grad_(
            grad and v.is_floating_point()) for k, v in inputs.items()}
        with torch.set_grad_enabled(grad):
            out = f(**ins)
        outs = [o for o in _leaves(out) if isinstance(o, torch.Tensor)]
        grads = []
        if grad:
            g = torch.Generator().manual_seed(7)
            loss = sum((o.float() * torch.randn(o.shape, generator=g)).sum()
                       for o in outs if o.is_floating_point())
            loss.backward()
            grads = [ins[k].grad for k in sorted(ins)
                     if ins[k].requires_grad]
        res.append(([o.detach() for o in outs], grads))
    return res


def _assert_bitwise(res):
    (out, grads), (t_out, t_grads) = res
    assert len(out) == len(t_out) and len(grads) == len(t_grads)
    for a, b in zip(out + grads, t_out + t_grads):
        assert a is not None and b is not None
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("mask", ["full", "causal", "window"])
def test_attention_core_bitwise_its_twin(mask, grad, dtype):
    from repro_torch.models.common import _attention_core
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 16, generator=g).to(dtype)
    k = torch.randn(2, 40, 4, 16, generator=g).to(dtype)
    v = torch.randn(2, 40, 4, 16, generator=g).to(dtype)
    kw = dict(causal=mask != "full", window=12 if mask == "window" else 0,
              chunk=16)
    _assert_bitwise(_run_both(
        lambda q, k, v: _attention_core(q, k, v, **kw),
        lambda q, k, v: twin_attention_core(q, k, v, **kw),
        {"q": q, "k": k, "v": v}, grad))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("which", ["rms", "rms_noscale", "layer"])
def test_norms_bitwise_their_twins(which, grad, dtype):
    from repro_torch.models.common import layer_norm_nonparam, rms_norm
    g = torch.Generator().manual_seed(1)
    x = (3 * torch.randn(2, 9, 48, generator=g) + 0.5).to(dtype)
    scale = torch.randn(48, generator=g)
    if which == "layer":
        fns = (layer_norm_nonparam, twin_layer_norm_nonparam)
        ins = {"x": x}
    elif which == "rms":
        fns = (rms_norm, twin_rms_norm)
        ins = {"x": x, "scale": scale}
    else:
        fns = (lambda x: rms_norm(x, None), lambda x: twin_rms_norm(x, None))
        ins = {"x": x}
    _assert_bitwise(_run_both(*fns, ins, grad))


def _block(kind: str, seed: int, dtype=torch.float32):
    from repro_torch.configs.base import reduced
    from repro_torch.models import griffin, registry, xlstm
    from repro_torch.models.common import init_params
    arch = "recurrentgemma-9b" if kind == "rglru" else "xlstm-1.3b"
    cfg = reduced(registry.get_config(arch))
    specs = {"rglru": griffin.rglru_specs, "mlstm": xlstm.mlstm_specs,
             "slstm": xlstm.slstm_specs}[kind](cfg)
    p = init_params(specs, torch.Generator().manual_seed(seed), dtype, "cpu")
    return cfg, p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_blocks_bitwise_their_twins(kind, grad, state, dtype,
                                          xlstm_chunk):
    from repro_torch.models import xlstm
    cfg, p = _block(kind, 3)
    S = 2 * XL_CHUNK if kind == "mlstm" else 24       # two mLSTM chunks
    g = torch.Generator().manual_seed(4)
    ins = {"x": torch.randn(2, S, cfg.d_model, generator=g).to(dtype),
           **{f"p_{k}": v for k, v in p.items()}}
    st = None
    if state:
        specs = (xlstm.mlstm_state_specs if kind == "mlstm"
                 else xlstm.slstm_state_specs)(cfg, 2)
        st = {k: 0.1 * torch.randn(s.shape, generator=g)
              for k, s in specs.items()}

    def call(fn):
        def run(x, **kw):
            w = types.SimpleNamespace(**{k[2:]: v for k, v in kw.items()})
            return fn(w, x, cfg, st)
        return run
    new = xlstm.mlstm_apply if kind == "mlstm" else xlstm.slstm_apply
    twin = twin_mlstm_apply if kind == "mlstm" else twin_slstm_apply
    _assert_bitwise(_run_both(call(new), call(twin), ins, grad))


def test_loss_logsumexp_bitwise_its_twin():
    from repro_torch.models.registry import _LogSumExp
    g = torch.Generator().manual_seed(5)
    logits = 4 * torch.randn(3, 7, 301, generator=g)
    targets = torch.randint(0, 301, (3, 7), generator=g)

    def new(logits):
        lse = _LogSumExp.apply(logits)
        picked = torch.gather(logits, -1, targets[..., None])[..., 0]
        return (lse - picked).mean()
    _assert_bitwise(_run_both(
        new, lambda logits: twin_loss(logits, targets), {"logits": logits},
        True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_griffin_gates_bitwise_their_twin_without_autograd(dtype):
    from repro_torch.models import griffin
    cfg, p = _block("rglru", 6)
    w = types.SimpleNamespace(**p)
    xr = torch.randn(2, 33, cfg.rnn_dim or cfg.d_model,
                     generator=torch.Generator().manual_seed(6)).to(dtype)
    with torch.no_grad():
        got, want = griffin._gates(w, xr), twin_gates(w, xr)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("S", [1, 2, 5, 8, 33, 64])
def test_linear_scan_forward_bitwise_its_twin(S):
    from repro_torch.models.griffin import linear_scan
    g = torch.Generator().manual_seed(S)
    a = torch.rand(3, S, 7, generator=g) * 0.5 + 0.5
    b = torch.randn(3, S, 7, generator=g)
    want = twin_linear_scan(a, b)
    with torch.no_grad():
        assert torch.equal(linear_scan(a.clone(), b.clone()), want)
    a0, b0 = a.clone(), b.clone()
    h = linear_scan(a.requires_grad_(), b.requires_grad_())
    assert torch.equal(h.detach(), want)
    # under autograd the inputs are left as they were
    assert torch.equal(a.detach(), a0) and torch.equal(b.detach(), b0)


def _rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("state", [False, True])
def test_rglru_gradients_near_its_twin_and_the_reference(state):
    """The scan's own backward: the block's gradients against autograd
    through the twin scan and against ``jax.grad`` of the reference."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import reduced as rreduced
    from repro.models import griffin as rgriffin, registry as rreg
    from repro_torch.models import griffin
    cfg, p = _block("rglru", 8)
    rcfg = rreduced(rreg.get_config("recurrentgemma-9b"))
    r = cfg.rnn_dim or cfg.d_model
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    proj = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    st = ({"h": 0.3 * rng.standard_normal((2, r)).astype(np.float32),
           "conv": 0.3 * rng.standard_normal(
               (2, cfg.conv_width - 1, r)).astype(np.float32)}
          if state else None)

    def port_grads(scan):
        w = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
        xt = torch.from_numpy(x).requires_grad_()
        old = griffin.linear_scan
        griffin.linear_scan = scan
        try:
            y, new_st = griffin.rglru_apply(
                types.SimpleNamespace(**w), xt, cfg,
                None if st is None else {k: torch.from_numpy(v)
                                         for k, v in st.items()})
        finally:
            griffin.linear_scan = old
        loss = (y * torch.from_numpy(proj)).sum() + new_st["h"].sum()
        loss.backward()
        return {"x": xt.grad, **{k: v.grad for k, v in w.items()}}
    got = port_grads(griffin.linear_scan)
    twin = port_grads(twin_linear_scan)
    for k in got:
        assert _rel_max(got[k], twin[k]) <= SCAN_GRAD_TWIN, k

    def ref_loss(params, xx):
        y, new_st = rgriffin.rglru_apply(
            params, xx, rcfg,
            None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
        return (y * proj).sum() + new_st["h"].sum()
    ref_p = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    gp, gx = jax.grad(ref_loss, argnums=(0, 1))(ref_p, jnp.asarray(x))
    want = {"x": gx, **gp}
    for k in got:
        assert _rel_max(got[k], torch.from_numpy(np.array(want[k]))) <= \
            SCAN_GRAD_REF, k


def test_prefill_cache_placed_as_decode_reads_it():
    """On (1, 8) a prefill's attention cache leaves sharded as the decode
    step's cache input is placed (the sequence over ``model``), where the
    four kv heads of reduced Mistral-NeMo do not divide the axis; on
    (4, 2), where they do, it stays sharded by its heads."""
    from repro_torch.configs.base import RunShape, reduced
    from repro_torch.distributed import op_cost
    from repro_torch.distributed.sharding import fake_world, named_mesh
    from repro_torch.launch import dryrun
    from repro_torch.models import registry
    from torch.distributed.tensor import Shard
    cfg = reduced(registry.get_config("mistral-nemo-12b"))
    rs = RunShape("t", 32, 8, "prefill")
    with fake_world(8):
        for shape, by_seq in (((1, 8), True), ((4, 2), False)):
            mesh = named_mesh(shape, ("data", "model"), "cpu")
            rules = dryrun.rules_for(cfg, rs, mesh)
            step, args = dryrun.cell_program(cfg, rs, mesh, rules, "cpu")
            held = {}

            def run(*a):
                held["out"] = step(*a)
                return held["out"]
            with dryrun.traced(mesh, rules):
                op_cost.analyze(run, *args)
            leaf = held["out"][1]["units"][0]["b0"]["k"]
            local = leaf.to_local().shape
            if by_seq:
                assert leaf.placements[1] == Shard(1)
                assert local[1] == 32 // 8 and local[2] == cfg.n_kv_heads
            else:
                assert leaf.placements[1] == Shard(2)
                assert local[1] == 32 and local[2] == cfg.n_kv_heads // 2
