"""Multi-rank training of the port (``repro_torch.launch.train`` over a
``(data, model)`` mesh of real gloo ranks, rank-aware checkpoints and the
elastic restore with a ``sharding_fn``) against the reference's
multi-device runs on host devices (``--xla_force_host_platform_device_count``).

Every group of ranks and every multi-device reference run is a child
process (``tests/_torch_mesh_children.py``): ranks join through a
``file://`` store under ``tmp_path`` or ``torchrun --standalone``; the
reference sets its device count before JAX starts.  Reduced OLMo-1B in
float32 throughout, on the reference's own seed-0 parameters.

Tolerances (measured on the CPU in brackets):

* restores across mesh sizes, a checkpoint saved by several ranks against
  a one-process save of the same values, and the tokens of every rank:
  bitwise;
* a placed step's loss and gradients on (2, 2), (1, 4) and (4, 1) against
  the plain one-process step and the reference's jitted step with the same
  placements: loss rtol 1e-5; each gradient leaf within 1e-4 in the norm
  of the difference over its norm and in its largest difference over its
  largest magnitude [2.4e-5 and 3.2e-5, wq / wk and embed against the
  reference; the plain port is itself 2.0e-5 from the reference]: the
  sharded products add their partial sums in another order;
* ``launch.train.main`` on 2 and 8 ranks against the reference on 2 and 8
  host devices, the checkpoints of steps 6 and 12: every parameter and
  moment leaf within 5e-3 in the same two measures [step 12: 1.4e-3 and
  2.1e-3, 8 ranks, m of wk and embed; the reference on 8 devices is 2.0e-3
  from itself on 2]: the clip divides by a grad norm of ~90, and AdamW's
  ``m / sqrt(v)`` turns a rounding of a near-zero gradient into a share of
  the learning rate, which the later steps carry
  (``tests/test_torch_train.py``'s ten-step losses, rtol 1e-3, for the
  same reason);
* 6 steps on 4 ranks resumed on 2 ranks to 12 against 12 uninterrupted
  steps of one plain process: the same bound [1.5e-3, embed].
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_port import torch_threads  # noqa: F401
from _torch_mesh_children import B, S, SHAPES, flat, unflat
from repro.configs.base import reduced as r_reduced
from repro.data.tokens import TokenPipeline as RPipeline
from repro.data.tokens import TokenPipelineConfig as RPipelineConfig
from repro.models import registry as r_registry
from repro.models import transformer as r_tfm
from repro.train.checkpoint import CheckpointManager as RCheckpointManager
from repro_torch.configs.base import reduced
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.models import registry, weights
from repro_torch.train import train_step as ts
from repro_torch.train.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]
CHILD = str(ROOT / "tests" / "_torch_mesh_children.py")
TIMEOUT = 300
MAIN = ["--steps", "12", "--batch", "4", "--seq", "16", "--ckpt-every", "6"]
GRAD_TOL, STATE_TOL = 1e-4, 5e-3

pytestmark = pytest.mark.usefixtures("torch_threads")


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    return dict(env, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1", **extra)


def _ranks(job: str, n: int, store: Path, *args) -> list:
    """``n`` ranks of ``job`` joined through the file store ``store``."""
    return [subprocess.Popen(
        [sys.executable, CHILD, job, str(r), str(n), str(store), *map(str, args)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]


def _torchrun(n: int, npz, sigterm: str, argv: list) -> subprocess.Popen:
    """``launch.train.main`` on ``n`` gloo ranks under ``torchrun``
    (``n = 0``: one plain process, no group)."""
    lead = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={n}"] if n else [sys.executable])
    return subprocess.Popen(
        lead + [CHILD, "train", str(npz), sigterm] + argv + ["--device",
                                                             "cpu"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _reference_main(n: int, argv: list) -> subprocess.Popen:
    env = _env(XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
    return subprocess.Popen([sys.executable, "-m", "repro.launch.train"] + argv,
                            env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _done(proc) -> str:
    out, err = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, err[-3000:]
    return out


def _results(procs) -> list:
    return [json.loads(_done(p).strip().splitlines()[-1]) for p in procs]


def _lines(out: str) -> list:
    return [ln for ln in out.splitlines()
            if ln.startswith(("arch=", "done:"))]


def _ckpt(path: Path) -> dict:
    """A checkpoint's leaves by key, as float32 numpy."""
    man = json.loads((path / "manifest.json").read_text())
    return {k: np.load(path / f"arr_{i:05d}__shard0.npy").astype(np.float32)
            for i, k in enumerate(man["keys"])}


def _near(got, want, tol: float, what: str) -> None:
    """``got`` within ``tol`` of ``want`` in the norm of the difference
    over the norm, and in the largest difference over the largest
    magnitude."""
    d = np.asarray(got, np.float64) - want
    assert np.linalg.norm(d) <= tol * np.linalg.norm(want), \
        f"{what}: |d| {np.linalg.norm(d):.3g} of {np.linalg.norm(want):.3g}"
    assert np.abs(d).max() <= tol * np.abs(want).max(), \
        f"{what}: max |d| {np.abs(d).max():.3g} of {np.abs(want).max():.3g}"


def _close_trees(got: dict, want: dict, tol: float, what: str) -> None:
    assert list(got) == list(want)
    for k in want:
        _near(got[k], want[k], tol, f"{what} {k}")


@pytest.fixture(scope="module")
def ref_np():
    cfg = r_reduced(r_registry.get_config("olmo-1b"))
    return jax.tree.map(np.asarray, r_tfm.init_params(cfg,
                                                      jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ref_npz(ref_np, tmp_path_factory):
    path = tmp_path_factory.mktemp("params") / "ref.npz"
    np.savez(path, **flat(ref_np))
    return path


# ---------------------------------------------------------------------------
# elastic checkpoints (the twin of tests/test_distributed.py's)
# ---------------------------------------------------------------------------

def test_elastic_checkpoint_restore_across_mesh_sizes(tmp_path):
    """Written by one process, restored on 8 ranks over (8,) ``data``:
    each rank's shard is its slice, the whole tensor the one written; saved
    again by the 8 ranks and restored by one process; placed on (2, 4),
    saved and restored on (4, 2).  All bitwise."""
    one = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
           "b": torch.ones(16)}
    CheckpointManager(str(tmp_path / "one")).save(5, one,
                                                  extras={"next_step": 5})
    res = _results(_ranks("elastic", 8, tmp_path / "store", tmp_path))
    assert all(r["1to8"] and r["24to42"] for r in res), res
    back, extras = CheckpointManager(str(tmp_path / "eight")).restore(
        6, {k: torch.zeros_like(v) for k, v in one.items()})
    assert extras == {"next_step": 6}
    for k in one:
        assert torch.equal(back[k], one[k])
    a, b = tmp_path / "one" / "step_00000005", tmp_path / "eight" / "step_00000006"
    for f in sorted(p.name for p in a.glob("arr_*")):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


# ---------------------------------------------------------------------------
# a placed step on four ranks, the checkpoint its ranks save, the tokens
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_runs(ref_npz, tmp_path_factory):
    out = tmp_path_factory.mktemp("step")
    ref = subprocess.Popen([sys.executable, CHILD, "refstep", str(out)],
                           env=_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    ranks = _ranks("step", 4, out / "store", ref_npz, out)
    res = _results(ranks)
    _done(ref)
    return out, res


@pytest.fixture(scope="module")
def plain_step(ref_np):
    """The plain one-process step's loss and gradients on the same
    parameters and batch."""
    cfg = reduced(registry.get_config("olmo-1b"))
    model = weights.model_from_reference(cfg, ref_np, "cpu")
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=S,
                                             global_batch=B))
    loss, grads = ts._loss_and_grads(model, ts._model_batch(
        model, pipe.batch_at(0)))
    return float(loss), flat(weights.tree_to_reference(grads))


@pytest.mark.parametrize("shape", [f"{a}x{b}" for a, b in SHAPES])
def test_placed_step_matches_plain_and_reference(step_runs, plain_step,
                                                 shape):
    out, res = step_runs
    data = int(shape.split("x")[0])
    assert all(r[shape]["local_rows"] == B // data for r in res)
    got = dict(np.load(out / f"{shape}.npz"))
    ref = dict(np.load(out / f"ref_{shape}.npz"))
    loss, grads = plain_step
    for want_loss, want, what in ((loss, grads, "plain"),
                                  (float(ref.pop("loss")), ref, "reference")):
        np.testing.assert_allclose(float(got["loss"]), want_loss, rtol=1e-5,
                                   err_msg=what)
        assert sorted(k for k in got if k != "loss") == sorted(want)
        for k in want:
            _near(got[k], want[k], GRAD_TOL, f"{shape} vs {what}: {k}")


def test_ranks_checkpoint_is_a_one_process_save(step_runs, tmp_path):
    """The checkpoint 4 ranks saved on (2, 2) after a step is byte for byte
    the one-process save of the same values, and the reference's
    ``CheckpointManager.restore`` reads its float32 leaves."""
    out, _ = step_runs
    cfg = reduced(registry.get_config("olmo-1b"))
    npz = dict(np.load(out / "state.npz"))
    tree = unflat({k[2:]: v for k, v in npz.items() if k[:2] == "0/"})
    st = unflat({k[2:]: v for k, v in npz.items() if k[:2] == "1/"})
    st["step"] = npz["step"]
    model = weights.model_from_reference(cfg, tree, "cpu")
    state = weights.opt_state_from_reference(cfg, st, "cpu")
    CheckpointManager(str(tmp_path)).save(
        1, (weights.param_tree(model), state), extras={"next_step": 1})
    a, b = out / "ckpt" / "step_00000001", tmp_path / "step_00000001"
    names = sorted(p.name for p in b.iterdir())
    assert sorted(p.name for p in a.iterdir()) == names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    target = (jax.tree.map(np.zeros_like, tree),
              {"m": jax.tree.map(np.zeros_like, tree),
               "v": jax.tree.map(np.zeros_like, tree),
               "step": np.zeros((), np.int32)})
    restored, extras = RCheckpointManager(str(out / "ckpt")).restore(1, target)
    assert extras == {"next_step": 1}
    want = {**{f"0/{k}": v for k, v in flat(tree).items()},
            **{f"1/{k}": v for k, v in flat({"m": st["m"],
                                             "v": st["v"]}).items()}}
    got = {**{f"0/{k}": v for k, v in flat(restored[0]).items()},
           **{f"1/{k}": v for k, v in flat({"m": restored[1]["m"],
                                            "v": restored[1]["v"]}).items()}}
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    assert int(restored[1]["step"]) == 1


def test_tokens_of_one_host_are_one_process_batch(step_runs):
    """Every rank of one host makes ``batch_at`` of one process, bitwise
    the reference's; as two hosts of two ranks, each host's ranks make the
    reference's slice of that process index."""
    out, res = step_runs
    cfg = reduced(registry.get_config("olmo-1b"))
    one = RPipeline(RPipelineConfig(vocab=cfg.vocab, seq_len=S,
                                    global_batch=B)).batch_at(3)["tokens"]
    port = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=S,
                                             global_batch=B)).batch_at(3)
    np.testing.assert_array_equal(port["tokens"], one)
    hosts = dict(np.load(out / "ref_tokens.npz"))
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(np.asarray(r["tokens"], np.int32), one)
        np.testing.assert_array_equal(
            np.asarray(r["tokens_2hosts"], np.int32), hosts[str(rank // 2)])


# ---------------------------------------------------------------------------
# launch.train.main over ranks against the reference over host devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def main_runs(ref_npz, tmp_path_factory):
    root = tmp_path_factory.mktemp("main")
    procs = {}
    for n in (2, 8):
        procs[("port", n)] = _torchrun(
            n, ref_npz, "-", MAIN + ["--ckpt-dir", str(root / f"port{n}")])
        procs[("ref", n)] = _reference_main(
            n, MAIN + ["--ckpt-dir", str(root / f"ref{n}")])
    return root, {k: _done(p) for k, p in procs.items()}


@pytest.mark.parametrize("n", [2, 8])
def test_train_main_over_ranks_matches_reference(main_runs, n):
    root, outs = main_runs
    port, ref = _lines(outs[("port", n)]), _lines(outs[("ref", n)])
    mesh = f"mesh={{'data': 1, 'model': {n}}}"
    assert port[0] == ref[0] and port[0].endswith(mesh)
    assert len(port) == len(ref) == 2
    done = (r"done: steps=(\d+) loss \d+\.\d{3} → \d+\.\d{3} "
            r"resumed_from=(\w+) stragglers=\d+")
    assert re.fullmatch(done, port[1]).groups() == \
        re.fullmatch(done, ref[1]).groups() == ("12", "None")
    names = sorted(p.name for p in (root / f"port{n}").iterdir())
    assert names == sorted(p.name for p in (root / f"ref{n}").iterdir()) == \
        ["step_00000006", "step_00000012"]
    for name in names:
        _close_trees(_ckpt(root / f"port{n}" / name),
                     _ckpt(root / f"ref{n}" / name), STATE_TOL,
                     f"{n} ranks {name}")


def test_resume_across_mesh_sizes(ref_npz, tmp_path):
    """Every rank of a 4-rank ``main`` sends itself SIGTERM while the data
    of step 5 is drawn: all save step 6 and stop; 2 ranks resume there to
    12, within the stated bounds of one plain process's 12 uninterrupted
    steps."""
    d = str(tmp_path / "ranks")
    plain = _torchrun(0, ref_npz, "-", MAIN + ["--ckpt-dir",
                                               str(tmp_path / "plain")])
    first = _lines(_done(_torchrun(4, ref_npz, "*:5",
                                   MAIN + ["--ckpt-dir", d])))
    assert first[0].endswith("mesh={'data': 1, 'model': 4}")
    assert re.search(r"steps=6 .*resumed_from=None", first[1]), first
    assert sorted(os.listdir(d)) == ["step_00000006"]
    second = _lines(_done(_torchrun(2, ref_npz, "-", MAIN + ["--ckpt-dir",
                                                             d])))
    assert second[0].endswith("mesh={'data': 1, 'model': 2}")
    assert re.search(r"steps=6 .*resumed_from=6", second[1]), second
    assert _lines(_done(plain))[0].endswith("mesh={'data': 1, 'model': 1}")
    _close_trees(_ckpt(tmp_path / "ranks" / "step_00000012"),
                 _ckpt(tmp_path / "plain" / "step_00000012"), STATE_TOL,
                 "4 then 2 ranks vs one process")
