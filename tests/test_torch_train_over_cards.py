"""``scripts/train_over_cards.py`` rehearsed on gloo ranks, and the rows of
two ``torchrun`` launchers that act as two hosts.

Every group of ranks is a child process (the script's ``torchrun``
launchers, or ``tests/_torch_mesh_children.py``'s ``tokens`` job), its
files under ``tmp_path``.  Bounds, as the script holds them:

* the ``smoke`` preset (float32) on (2, 2) and (4, 1) from two launchers
  against one process drawing the same rows: the first loss within 1e-5,
  every first-step gradient leaf within 1e-4 in both of the script's
  measures [4.8e-7 and 5.2e-7 here], the same with no bf16 on either side,
  the same in float64 within 1e-12 (loss) and 1e-10 (leaves) [1.2e-15],
  each rank's rows ``batch // D``, each host's rows bitwise;
* the two-launcher (2, 2) checkpoint of step 6 restored on (1, 1), (2, 2)
  and (4, 1) from one launcher: every parameter and moment leaf, saved
  again by the ranks, bitwise the files; step 12 within 5e-3 of one
  process's 12 steps on the same rows [2.9e-5];
* (1, 4) over two hosts: ``place_rows``'s error, since a batch split by
  host needs a data axis;
* two hosts' rows: bitwise the rows the reference's two processes make.
  The reference keys a host's rows on (seed, step, its first row), so the
  two halves are not the one-host batch; the script's one-process
  reference draws both hosts' rows instead.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from _torch_port import torch_threads  # noqa: F401
from repro.data.tokens import TokenPipeline as RPipeline
from repro.data.tokens import TokenPipelineConfig as RPipelineConfig
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = str(ROOT / "scripts" / "train_over_cards.py")
CHILD = str(ROOT / "tests" / "_torch_mesh_children.py")
TIMEOUT = 240
SMOKE = ["--device", "cpu", "--preset", "smoke", "--batch", "4", "--seq",
         "16", "--tol", "1e-4", "--timeout", "120"]

pytestmark = pytest.mark.usefixtures("torch_threads")


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    return dict(env, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                **extra)


def _script(tmp_path, *args) -> tuple[dict, str]:
    """The script's run, its files under ``tmp_path``: its last line's
    JSON and its whole output."""
    out = subprocess.run([sys.executable, SCRIPT, *SMOKE, *args],
                         env=_env(TMPDIR=str(tmp_path)), capture_output=True,
                         text=True, timeout=TIMEOUT)
    lines = out.stdout.strip().splitlines()
    assert lines, out.stderr[-3000:]
    return json.loads(lines[-1]), out.stdout + out.stderr[-3000:]


def test_two_launchers_rehearsal_with_restores(tmp_path):
    res, log = _script(tmp_path, "--steps", "12", "--ckpt-every", "6",
                       "--meshes", "1x1,2x2,4x1", "--hosts", "2")
    assert res["ok"], log
    runs = {r["run"]: r for r in res["runs"]}
    assert list(runs) == ["ref_h2", "2x2h2", "4x1h2", "restore1x1",
                          "restore2x2", "restore4x1"], log
    for name, rows in (("2x2h2", [2] * 4), ("4x1h2", [1] * 4)):
        r = runs[name]
        d, m = r["mesh"]
        assert r["hosts"] == 2 and r["rows"] == rows
        assert r["mesh_line"].endswith(f"mesh={{'data': {d}, 'model': {m}}}")
        assert r["loss_rel"] <= 1e-5 and r["grad_worst"] <= 1e-4, r
        assert r["unrounded_loss_rel"] <= 1e-5, r
        assert r["unrounded_grad_worst"] <= 1e-4, r
        assert r["float64_loss_rel"] <= 1e-12, r
        assert r["float64_grad_worst"] <= 1e-10, r
        assert r["settings_agree"], r
        assert r["tokens_bitwise"] and np.isfinite(r["losses"]).all()
    ref = runs["ref_h2"]
    assert ref["settings"] == {"allow_tf32": False, "nccl": None,
                               "float32_matmul_precision": "highest"}, ref
    assert 0 < ref["f32_from_float64"] < 1e-4, ref
    for name in ("restore1x1", "restore2x2", "restore4x1"):
        r = runs[name]
        assert r["restored_bitwise"] and r["resumed_from"] == 6, r
        assert len(r["losses"]) == 6 and r["last_worst"] <= 5e-3, r


def test_a_batch_split_by_host_needs_a_data_axis(tmp_path):
    res, log = _script(tmp_path, "--steps", "1", "--meshes", "1x1,1x4",
                       "--hosts", "2")
    assert res["ok"], log
    assert [r["run"] for r in res["runs"]] == ["ref_h1", "1x4h2"]
    assert "raised place_rows's error" in log, log


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_launchers_draw_the_reference_processes_rows(tmp_path,
                                                         monkeypatch):
    """Two ``torchrun`` launchers of two gloo ranks each (a static
    rendezvous): every rank of host ``h`` draws the reference's rows of
    process ``h`` of 2, bitwise; the two halves, concatenated, are the
    global batch of the reference's two processes, not its one-process
    batch."""
    batch, seq, vocab = 8, 16, 512
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2",
         "--node-rank", str(h), "--nproc-per-node", "2", "--master-addr",
         "127.0.0.1", "--master-port", str(port), CHILD, "tokens",
         str(tmp_path), str(batch), str(seq), str(vocab)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for h in (0, 1)]
    for p in procs:
        _, err = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, err[-3000:]
    cfg = RPipelineConfig(vocab=vocab, seq_len=seq, global_batch=batch)
    halves = {}
    for pid in (0, 1):
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        halves[pid] = {s: RPipeline(cfg).batch_at(s)["tokens"]
                       for s in (0, 1)}
    one = TokenPipeline(TokenPipelineConfig(vocab=vocab, seq_len=seq,
                                            global_batch=batch))
    for s in (0, 1):
        for rank in range(4):
            got = np.load(tmp_path / f"rank{rank}.npz")[f"step{s}"]
            np.testing.assert_array_equal(got, halves[rank // 2][s])
        both = np.concatenate([halves[0][s], halves[1][s]])
        assert both.shape == (batch, seq)
        assert not np.array_equal(both, one.batch_at(s)["tokens"])
