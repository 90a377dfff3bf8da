"""The port's entry points (``repro_torch.launch``) against the reference:
``preset_config`` field by field, the serving driver's tokens (plain and
through the kNN-softmax head) on the reference's own parameters, the
training driver end to end with a resume, the meshes and the dry-run
table printer.

Tolerances: tokens equal.  The plain decode loop is compared at every
position of ten reduced architectures; where the port's float32 logits
(within ``_torch_port.model_tol`` of the reference's) pick another token,
that token's reference logit must lie within twice that tolerance of the
maximum (a near-tie), and the two streams are compared only up to there,
since they go on from different tokens.  Checkpoints and printed files go
under ``tmp_path``.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import model_tol, torch_threads  # noqa: F401
from repro.configs.base import reduced as r_reduced
from repro.launch import serve as r_serve
from repro.launch import summarize as r_summarize
from repro.launch import train as r_train
from repro.models import registry as r_registry
from repro.models import transformer as r_tfm
from repro.serving.knn_softmax import KnnSoftmaxHead as RHead
from repro_torch.configs.base import reduced
from repro_torch.launch import mesh, serve, summarize, train
from repro_torch.models import registry, weights
from repro_torch.serving.knn_softmax import KnnSoftmaxHead

B, P, T = 4, 32, 32          # serve.py's defaults: batch, prompt, tokens
HEAD = dict(th=64, r_candidates=64, nbr_nodes=8)

pytestmark = pytest.mark.usefixtures("torch_threads")


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")


def _reference_generate(name: str, head=None, frontend=None) -> SimpleNamespace:
    """``repro.launch.serve.main``'s loop on the reduced ``name`` with its
    seed-0 parameters and prompt: the tokens, each step's logits and
    (with a head) the hidden rows the head saw."""
    cfg = r_reduced(r_registry.get_config(name))
    params = r_tfm.init_params(cfg, jax.random.PRNGKey(0))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (B, P))
    batch = {"tokens": jnp.asarray(prompt, jnp.int32)}
    if cfg.family == "encdec":
        batch["frames"] = jnp.zeros((B, cfg.encoder_seq, cfg.d_model))
    if cfg.family == "vlm":
        batch["patches"] = jnp.zeros((B, cfg.vision_tokens, cfg.d_model))
    logits, cache = jax.jit(lambda p, b: r_tfm.forward_prefill(p, b, cfg))(
        params, batch)
    cache = jax.tree.map(
        lambda x: (jnp.pad(x, [(0, 0)] * (x.ndim - 3) +
                           [(0, P + T - x.shape[-3]), (0, 0), (0, 0)])
                   if x.ndim >= 4 and x.shape[-3] == P else x), cache)
    decode = jax.jit(lambda p, c, t, pos: r_tfm.forward_decode(
        p, c, t, pos, cfg, return_hidden=True))
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    toks, steps, hidden = [np.asarray(tok)], [np.asarray(logits[:, -1])], []
    for i in range(T - 1):
        logits, cache, h = decode(params, cache, tok, jnp.int32(P + i))
        steps.append(np.asarray(logits[:, -1]))
        if head is not None:
            hidden.append(np.asarray(h[:, 0, :], np.float32))
            tok = jnp.asarray(head.step_batch_via(frontend, hidden[-1]),
                              jnp.int32)[:, None]
        else:
            tok = jnp.argmax(logits[:, -1, :], -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
    return SimpleNamespace(params=jax.tree.map(np.asarray, params),
                           prompt=prompt, tokens=np.concatenate(toks, 1),
                           logits=np.stack(steps, 1), hidden=hidden)


def _port_model(name, params):
    return weights.model_from_reference(
        reduced(registry.get_config(name)), params, "cpu")


@pytest.mark.parametrize("arch", registry.ARCH_NAMES)
def test_preset_config_matches_reference(arch):
    for preset in ("smoke", "100m", "full"):
        assert dataclasses.asdict(train.preset_config(arch, preset)) == \
            dataclasses.asdict(r_train.preset_config(arch, preset)), preset
    with pytest.raises(ValueError):
        train.preset_config(arch, "huge")


def test_generate_matches_reference_main(monkeypatch, capsys):
    """``generate`` on the smoke preset with the reference's seed-0
    parameters and prompt: every token equal to the reference loop's, and
    row 0 equal to the ``sample:`` row ``repro.launch.serve.main`` prints
    under the same argv."""
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "olmo-1b",
                                     "--preset", "smoke"])
    r_serve.main()
    printed = capsys.readouterr().out
    sample = re.search(r"^sample: \[([\d\s]+)\]$", printed, re.M).group(1)
    want = _reference_generate("olmo-1b")
    cfg = reduced(registry.get_config("olmo-1b"))
    timings = {}
    got = serve.generate(cfg, _port_model("olmo-1b", want.params),
                         want.prompt, T, timings=timings)
    assert got.shape == (B, T) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want.tokens)
    np.testing.assert_array_equal(got[0][:16],
                                  np.array(sample.split(), np.int32))
    assert len(timings["step_s"]) == T - 1
    assert timings["prefill_s"] > 0 and timings["decode_s"] > 0


@pytest.mark.parametrize("arch", [a for a in registry.ARCH_NAMES
                                  if a != "olmo-1b"])
def test_generate_matches_reference_loop(arch):
    want = _reference_generate(arch)
    cfg = reduced(registry.get_config(arch))
    got = serve.generate(cfg, _port_model(arch, want.params), want.prompt, T)
    diff = np.nonzero((got != want.tokens).any(axis=0))[0]
    if len(diff):                        # a near-tie: compare up to there
        j = int(diff[0])
        for r in np.nonzero(got[:, j] != want.tokens[:, j])[0]:
            lg = want.logits[r, j]
            assert lg.max() - lg[got[r, j]] <= 2 * model_tol(arch) * max(
                abs(lg.max()), 1.0), (arch, r, j)
        got, want.tokens = got[:, :j], want.tokens[:, :j]
        assert j >= T // 4, (arch, j)
    np.testing.assert_array_equal(got, want.tokens)


def test_knn_head_tokens_match_reference():
    """The head path: each step's hidden rows of the reference loop through
    both heads (each through its own front-end) give equal tokens, and the
    port's ``generate`` with the head gives the reference loop's tokens."""
    cfg = reduced(registry.get_config("olmo-1b"))
    params = _reference_generate("olmo-1b").params
    lm_head = params["lm_head"].astype(np.float32)
    rhead = RHead(lm_head, **HEAD)
    head = KnnSoftmaxHead(lm_head, device="cpu", **HEAD)
    with rhead.make_frontend(max_batch=B, max_wait=0.002) as rfe:
        want = _reference_generate("olmo-1b", rhead, rfe)
    with head.make_frontend(max_batch=B, max_wait=0.002) as fe:
        for i, H in enumerate(want.hidden):
            np.testing.assert_array_equal(head.step_batch_via(fe, H),
                                          want.tokens[:, i + 1], err_msg=i)
    head2 = KnnSoftmaxHead(lm_head, device="cpu", **HEAD)
    with head2.make_frontend(max_batch=B, max_wait=0.002) as fe:
        got = serve.generate(cfg, _port_model("olmo-1b", params),
                             want.prompt, T, knn_head=head2, frontend=fe)
    np.testing.assert_array_equal(got, want.tokens)
    assert head2.stats.tokens == B * (T - 1)
    with pytest.raises(ValueError, match="front-end"):
        serve.generate(cfg, _port_model("olmo-1b", params), want.prompt, T,
                       knn_head=head2)


def test_serve_main_lines_match_reference_format(capsys):
    serve.main(["--device", "cpu", "--tokens", "8"])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"prefill 32 tokens x4: \d+\.\d\ds", out[0])
    assert re.fullmatch(r"decoded 7 steps x4 in \d+\.\d\ds \(\d+\.\d tok/s\)",
                        out[1])
    cfg = reduced(registry.get_config("olmo-1b"))
    from repro_torch.models import transformer as tfm
    model = tfm.init_params(cfg, torch.Generator("cpu").manual_seed(0), "cpu")
    want = serve.generate(cfg, model, np.random.default_rng(0).integers(
        0, cfg.vocab, (B, P)), 8)
    assert out[2] == f"sample: {want[0][:16]}"
    serve.main(["--device", "cpu", "--tokens", "4", "--knn-softmax"])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"knn-softmax stats: recall@R=\d\.\d\d "
                        r"argmax-agree=\d\.\d\d", out[2])
    assert out[3].startswith("frontend stats: {'submitted': 12, ")
    assert out[4].startswith("sample: [")


def test_train_main_runs_and_resumes(tmp_path, monkeypatch, capsys):
    """``main`` on the CPU: the reference's header and ``done:`` lines, a
    checkpoint every 6 steps, then a rerun to 18 steps resumes at 12.  The
    header equals the reference's ``main``'s under the same argv."""
    argv = ["--steps", "12", "--batch", "2", "--seq", "16", "--ckpt-every",
            "6", "--ckpt-dir", str(tmp_path / "port")]
    train.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    monkeypatch.setattr("sys.argv", ["train"] + argv[:-1] +
                        [str(tmp_path / "ref")])
    r_train.main()
    ref_out = capsys.readouterr().out.splitlines()
    assert out[0] == ref_out[0] == ("arch=olmo-1b preset=smoke params=0.1M "
                                    "mesh={'data': 1, 'model': 1}")
    done = (r"done: steps=(\d+) loss \d+\.\d{3} → \d+\.\d{3} "
            r"resumed_from=(\w+) stragglers=\d+")
    assert re.fullmatch(done, out[-1]).groups() == ("12", "None")
    assert re.fullmatch(done, ref_out[-1]).groups() == ("12", "None")
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir()) == \
        ["step_00000006", "step_00000012"]
    train.main(argv[:1] + ["18"] + argv[2:] + ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(done, out[-1]).groups() == ("6", "12")


def test_train_main_refuses_several_devices(monkeypatch):
    """A lone process that sees several devices trains on none of them:
    one rank per device runs under ``torchrun``."""
    monkeypatch.setattr(train, "make_host_mesh",
                        lambda device: mesh.make_mesh(["cpu", "cpu"]))
    with pytest.raises(RuntimeError, match="torchrun"):
        train.main(["--device", "cpu", "--steps", "1"])


def test_train_main_over_two_cpu_ranks(tmp_path):
    """``main`` under ``torchrun`` on two gloo ranks: the reference's
    header with its two-device mesh; rank 1 alone sends itself SIGTERM
    while the data of step 2 is drawn, and both ranks stop after that
    step and save step 3 together; a rerun resumes there to 6."""
    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    argv = ["--steps", "6", "--batch", "2", "--seq", "16", "--ckpt-every",
            "100", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    done = (r"done: steps=(\d+) loss \d+\.\d{3} → \d+\.\d{3} "
            r"resumed_from=(\w+) stragglers=\d+")
    for sigterm, want in (("1:2", ("3", "None")), ("-", ("3", "3"))):
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node=2", str(root / "tests" / "_torch_mesh_children.py"),
             "train", "-", sigterm] + argv,
            env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith(("arch=", "done:"))]
        assert lines[0] == ("arch=olmo-1b preset=smoke params=0.1M "
                            "mesh={'data': 1, 'model': 2}")
        assert re.fullmatch(done, lines[1]).groups() == want
        assert sorted(p.name for p in tmp_path.iterdir()) == \
            ["step_00000003"]


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_host_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with mesh.world():
            pass
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_rank_mesh()
    assert not list(tmp_path.iterdir())


def test_meshes():
    m = mesh.make_host_mesh("cpu")
    assert m.size == 1 and m.devices == (torch.device("cpu"),)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for multi, need in ((False, 256), (True, 512)):
        if n < need:
            with pytest.raises(RuntimeError, match=f"needs {need} devices"):
                mesh.make_production_mesh(multi_pod=multi)


def _records():
    """Hand-made dry-run records: two ok cells on each mesh (one a
    decode), a skipped one and an error."""
    def ok(arch, shape, mesh_name, frac, coll, step, peak):
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "compile_s": 12.5,
                "roofline": {"compute_s": step * frac, "memory_s": 4e-4,
                             "collective_s": coll, "bottleneck": "compute",
                             "step_s": step, "roofline_fraction": frac,
                             "useful_ratio": 0.9},
                "memory": {"peak_per_device": peak},
                "collectives": {"per_kind": {"all-reduce": {"count": 3},
                                             "all-gather": {"count": 4}},
                                "total_bytes": 3 * 2 ** 30}}
    return [ok("olmo-1b", "train_4k", "pod_16x16", 0.42, 0.01, 1.5, 2 ** 34),
            ok("olmo-1b", "decode_32k", "pod_16x16", 0.07, 2e-5, 3e-3, 2 ** 31),
            ok("qwen3-32b", "decode_32k", "pod_16x16", 0.12, 4e-4, 8e-3,
               2 ** 33),
            ok("qwen3-32b", "train_4k", "multi_pod_2x16x16", 0.3, 0.2, 0.9,
               2 ** 35),
            {"arch": "whisper-base", "shape": "long_500k", "mesh": "pod_16x16",
             "skipped": "pure full-attention arch: 512k dense decode skipped"},
            {"arch": "xlstm-1.3b", "shape": "train_4k", "mesh": "pod_16x16",
             "error": "RESOURCE_EXHAUSTED: out of memory while compiling"}]


def test_summarize_tables_match_reference(tmp_path, monkeypatch, capsys):
    import json
    recs = _records()
    for mesh_name in ("pod_16x16", "multi_pod_2x16x16"):
        assert summarize.roofline_table(recs, mesh_name) == \
            r_summarize.roofline_table(recs, mesh_name)
    assert summarize.dryrun_table(recs) == r_summarize.dryrun_table(recs)
    assert summarize.pick_hillclimb(recs) == r_summarize.pick_hillclimb(recs)
    for x in (0, 5e-7, 2e-3, 1.5):
        assert summarize.fmt_s(x) == r_summarize.fmt_s(x)
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    assert summarize.load(str(tmp_path)) == r_summarize.load(str(tmp_path))
    monkeypatch.setattr("sys.argv", ["summarize", "--dir", str(tmp_path)])
    summarize.main()
    got = capsys.readouterr().out
    r_summarize.main()
    assert got == capsys.readouterr().out
