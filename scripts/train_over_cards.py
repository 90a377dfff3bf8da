"""``launch.train.main`` over ``(data, model)`` meshes of CUDA cards, from
one ``torchrun`` launcher or from several that act as hosts, held against
one card.

    python3 scripts/train_over_cards.py                    # 1x1,1x2,1x4
    python3 scripts/train_over_cards.py --preset smoke --batch 8 --seq 128 \\
        --tol 1e-4 --steps 12 --ckpt-every 6 --meshes 1x1,2x2,4x1,1x4 \\
        --hosts 1,2                                        # a 4-GPU machine
    python3 scripts/train_over_cards.py --device cpu --preset smoke \\
        --batch 4 --seq 16 --steps 12 --ckpt-every 6 --meshes 1x1,2x2,4x1 \\
        --hosts 2 --tol 1e-4                               # gloo rehearsal

Each mesh ``DxM`` of ``--meshes`` after the first is a run of ``main`` on
``D * M`` ranks, one card each, whose ``make_rank_mesh`` each rank's child
replaces with ``sharding.named_mesh((D, M), ("data", "model"))`` (``main``
keeps the reference's mesh choice).  It runs once from each launcher
count ``H`` of ``--hosts`` that divides its ranks: ``H = 1`` is
``torchrun --standalone``; ``H > 1`` is ``H`` launchers on this machine
(``--nnodes H --node-rank h``, a static rendezvous on ``127.0.0.1``), each
seeing its own ``D * M / H`` cards (``CUDA_VISIBLE_DEVICES``), so that each
host makes only its share of the batch (``data.tokens``).  A mesh whose
data axis ``H`` does not divide must fail there with ``place_rows``'s
"lie outside its host's" error (a batch split by host needs a data axis,
as the reference's does): checked, not trained.

Each run is held against one card: the first mesh of the list, from one
launcher, drawing the batches the run draws.  Those differ with the
number of hosts, as the reference's do: a host's rows are keyed on (seed,
step, its first row), so two hosts' halves are not the one-host batch.
So there is one such reference per launcher count, whose ranks draw every
host's rows of each step and train on them in host order.  With a
checkpoint before the last step (``--ckpt-every``), the first trained run
of several launchers is also restored at that step onto every mesh of the
list from one launcher, each continuing to the last step on one host's
batches, and the reference of its launcher count draws its hosts'
batches only before that step.

Its files (whole gradients, checkpoints) go to a temporary directory
under ``$TMPDIR``, or under ``build/`` where that is unset.  Every launch
is started ahead of its turn (``AHEAD`` at most waiting);
its ranks import and then wait for their gate, so start-up overlaps and no
two launches use the cards at once.  Printed and gated, each run against
its reference:

* the ``mesh=`` line and each rank's first-step rows (``batch // D``);
* the first step's loss within 1e-5 of the reference's, relative, and
  each first-step gradient leaf (gathered whole before any update) within
  ``--tol`` by both measures: the norm of the difference over its norm,
  and the largest difference over the largest magnitude (worst leaves
  printed first); every loss finite;
* the rows each host drew at steps 0 and 1, bitwise the rows the
  reference drew for that host;
* the same first step without bf16 on both sides (float32 compute, the
  attention's probabilities and their cotangents unrounded): the loss
  within 1e-5 and every gradient leaf within 1e-4 by both measures, the
  bound of a float32 placed step in ``tests/test_torch_train_mesh.py``.
  bf16 roundings move a gradient by up to its floor (below), and a
  placement rounds anew; without them less hides a fault.  At width
  float32 itself hides it: one card's float32 step lies 7.7e-3 from its
  float64 step for the ``100m`` preset and 0.21 for ``full`` (the query
  and key projections at initialisation), above this bound, and placed
  runs miss it by up to 7.0e-3 and 3.9e-3;
* the same first step in float64 on both sides (the config's
  ``param_dtype`` and ``compute_dtype`` ``"float64"``, the parameters
  cast, the roundings the identity): the loss within 1e-12 and every
  gradient leaf within 1e-8 by both measures.  In float64 a right
  placement agrees with one card to ~1e-12 whatever the conditioning (the
  ``100m`` preset 1.0e-14–1.4e-12 on (2, 2), (4, 1), (1, 4), (2, 1),
  (1, 2) from one and two launchers, ``full`` 1.2e-11 on (2, 2); four
  NVIDIA H100 80GB HBM3 at 700.00 W), and a term lost, doubled or scaled
  on a shard does not.  Also printed: this run's float32 step against
  the reference's float64 step, beside the reference's own float32 step
  against it;
* restores: each target's restored parameter and AdamW moment leaves,
  saved again by its ranks, bitwise the files restored; its last
  checkpoint within 5e-3 of the reference's in both measures (the bound
  ``tests/test_torch_train_mesh.py`` holds a gloo resume to).

Printed, not held: the later losses and the last checkpoint's leaves
(ranks add partial sums in another order, and the ``100m`` preset's AdamW,
a grad norm ~59 clipped to 1 and ``m / sqrt(v)`` of near-zero gradients,
turns one ulp of one gradient into 1.6e-4 of the loss by the fourth step:
``scripts/probe_placed_step.py``, NVIDIA H100 80GB HBM3, 700.00 W); step
ms; with CUDA each rank's ``max_memory_allocated``.

``--tol`` is 1e-2 by default, three times the ``100m`` gradient's own
floor (it moves 3.4e-3 of its norm between 1 and 4 CPU threads: its
attention rounds probabilities and their cotangents to bf16 even in
float32); 1e-4, the bound of ``tests/test_torch_train_mesh.py`` for a
placed step on gloo ranks, for the float32 ``smoke`` preset.  Each
reference also measures and prints its floor: the distance from its loss
and gradient to the same step's with the same weights and no bf16 (float32
compute, the attention's probabilities and their cotangents unrounded),
the size of the noise its roundings put there, which a placement rounds
anew.  The ``full`` preset (OLMo-1B at its width, bf16) has a floor of
1.56 in its gradient and 4.48e-5 in its loss, measured so on its first
step of 4 x 2048 on one NVIDIA H100 80GB HBM3 at 700.00 W; ``--tol 4.7``
is three times the first.  Its loss floor lies above the 1e-5 bound of
the first loss, which a placed bf16 step therefore cannot be held to.
The ``100m`` preset's floor measured so is 7.6e-2 in its gradient (the
attention's bf16 probabilities) and 1.3e-6 in its loss.  Each reference
also prints, without bf16, its gradient against the mean of its batch's
two halves' gradients: what a data axis of 2 changes in the sums over
rows.  Each rank records ``allow_tf32``, the float32 matmul precision
and the NCCL version it ran with (none is set here).  The last line is a
JSON object: ``ok`` and each launch's numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
AHEAD = 3           # launches started and waiting behind the running one
RESTORE_TOL = 5e-3
UNROUNDED_TOL = 1e-4    # a float32 placed step's (tests/test_torch_train_mesh)
F64_LOSS_TOL, F64_TOL = 1e-12, 1e-8     # the float64 step's
PLACE_ROWS_ERROR = "lie outside its host's"


def child(out: str, gate: str, mesh: str, role: str, argv: list) -> None:
    """One rank: once ``gate`` exists, ``main(argv)`` on the mesh ``mesh``
    (``DxM``) as ``role``: ``run``, ``ref:H:S`` (draw ``H`` hosts' rows
    before step ``S``) or ``restore:<dir>`` (the restored tree saved again
    into ``dir``).  Writes ``out.r<RANK>.json`` (rows, memory; rank 0 the
    trainer's report), rank 0 the first step's loss and gradients whole to
    ``out.npz`` and the same step's without bf16 to ``out.f32.npz`` (a
    reference also the mean of its batch's two halves' without bf16 to
    ``out.halves.npz``), the rows of each host at steps 0 and 1 to
    ``out.h<host>.npz``."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch.data import tokens
    from repro_torch.distributed.sharding import (batch_rows, is_dtensor,
                                                  named_mesh, whole)
    from repro_torch.launch import train
    from repro_torch.models import common
    from repro_torch.train import checkpoint, train_step, trainer
    torch.use_deterministic_algorithms(True, warn_only=True)
    rank, local = int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"])
    host = rank // int(os.environ["LOCAL_WORLD_SIZE"])
    parent = int(os.environ["TRAIN_OVER_CARDS_PID"])
    while not Path(gate).exists():
        try:
            os.kill(parent, 0)
        except ProcessLookupError:
            sys.exit("train_over_cards: the script is gone")
        time.sleep(0.02)
    shape = tuple(int(x) for x in mesh.split("x"))
    train.make_rank_mesh = lambda device: named_mesh(
        shape, ("data", "model"), device)
    kind, _, arg = role.partition(":")
    rec: dict = {"rank": rank}
    drawn: dict = {}
    first, run = train_step._loss_and_grads, trainer.Trainer.run
    batch_at, restore = (tokens.TokenPipeline.batch_at,
                         checkpoint.CheckpointManager.restore)
    hosts_of = tokens.process_rank_and_count

    def gathered(grads) -> dict:
        """The leaves whole (a collective), as numpy on rank 0: float64
        leaves as they are, any other as float32."""
        out = {}
        for k, g in named(grads):
            g = whole(g)
            if rank == 0:
                out[k] = (g if g.dtype == torch.float64 else
                          g.float()).cpu().numpy()
        return out

    def loss_and_grads(model, batch):
        loss, grads = first(model, batch)
        if train_step._loss_and_grads is not loss_and_grads:
            return loss, grads
        train_step._loss_and_grads = first          # the first step only
        tok = batch["tokens"]
        rec["rows"] = (tok.to_local() if is_dtensor(tok) else tok).shape[0]
        rec.update(settings())
        arrays = gathered(grads)
        if rank == 0:
            np.savez(out + ".npz", **arrays, loss=float(loss))
        if kind == "restore":
            return loss, grads
        # the same step without bf16 (float32 compute, the attention's
        # roundings the identity), then in float64
        rounds = common._RoundBF16, common._GradRoundBF16
        common._RoundBF16 = common._GradRoundBF16 = Unrounded
        try:
            f32 = copy_as(model, compute_dtype="float32")
            loss32, grads32 = first(f32, batch)
            arrays = gathered(grads32)
            del grads32
            if kind == "ref":       # the row split a data axis of 2 makes
                n = tok.shape[0] // 2
                halves = [gathered(first(f32, {
                    k: batch_rows(v, a, b) for k, v in batch.items()})[1])
                    for a, b in ((0, n), (n, 2 * n))]
            del f32
            loss64, grads64 = first(copy_as(
                model, param_dtype="float64", compute_dtype="float64"), batch)
            arrays64 = gathered(grads64)
            del grads64
        finally:
            common._RoundBF16, common._GradRoundBF16 = rounds
        if rank == 0:
            np.savez(out + ".f32.npz", **arrays, loss=float(loss32))
            np.savez(out + ".f64.npz", **arrays64, loss=float(loss64))
            if kind == "ref":
                np.savez(out + ".halves.npz", **{
                    k: (halves[0][k] + halves[1][k]) / 2 for k in arrays})
        return loss, grads

    def recorded(self, model, opt_state):
        model, opt_state, rep = run(self, model, opt_state)
        rec.update(losses=rep.losses, step_s=rep.step_times,
                   steps_run=rep.steps_run, resumed_from=rep.resumed_from)
        return model, opt_state, rep

    def rows_drawn(self, step):
        n, until = (int(x) for x in arg.split(":")) if kind == "ref" \
            else (1, 0)
        parts = {}
        if step < until:            # every host's rows, in host order
            for h in range(n):
                tokens.process_rank_and_count = lambda h=h: (h, n)
                try:
                    parts[h] = batch_at(self, step)
                finally:
                    tokens.process_rank_and_count = hosts_of
        else:
            parts[host] = batch_at(self, step)
        if local == 0 and step in (0, 1):
            for h, b in parts.items():
                drawn.setdefault(h, {})[f"step{step}"] = b["tokens"]
        return {k: np.concatenate([b[k] for b in parts.values()])
                for k in parts[min(parts)]}

    def restored(self, step, target, sharding_fn=None):
        tree, extras = restore(self, step, target, sharding_fn)
        checkpoint.CheckpointManager(arg).save(step, tree, extras=extras)
        return tree, extras

    train_step._loss_and_grads = loss_and_grads
    trainer.Trainer.run = recorded
    tokens.TokenPipeline.batch_at = rows_drawn
    if kind == "restore":
        checkpoint.CheckpointManager.restore = restored
    train.main(argv)
    if torch.cuda.is_available():
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    for h, rows in drawn.items():
        np.savez(f"{out}.h{h}.npz", **rows)
    Path(f"{out}.r{rank}.json").write_text(json.dumps(rec))


def copy_as(model, **dtypes):
    """``model`` with its config's ``dtypes`` replaced and its parameters
    (placed as they are) cast to its ``param_dtype``: the steps without
    bf16 (with :class:`Unrounded`) are taken on such copies."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import DTYPES, map_tree
    from repro_torch.models.weights import param_tree
    cfg = dataclasses.replace(model.cfg, **dtypes)
    dt = DTYPES[cfg.param_dtype]
    return tfm.Transformer(cfg, map_tree(lambda p: p.detach().to(dt),
                                         param_tree(model)))


class Unrounded:
    """Stands for ``models.common``'s bf16 roundings of the attention
    probabilities and their cotangents: the identity."""

    @staticmethod
    def apply(x):
        return x


SETTINGS = ("allow_tf32", "float32_matmul_precision", "nccl")


def settings() -> dict:
    """The settings that choose a float32 product's arithmetic, and the
    NCCL version where CUDA is present."""
    import torch
    cuda = torch.cuda.is_available()
    return {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision(),
            "nccl": ".".join(map(str, torch.cuda.nccl.version()))
            if cuda else None}


def named(tree, at: str = ""):
    """``(path, leaf)`` of a tree of dicts and lists, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named(tree[k], f"{at}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from named(v, f"{at}/{i}")
    else:
        yield at, tree


def leaves(path: Path) -> dict:
    """A checkpoint's leaves by key, as written."""
    import numpy as np
    man = json.loads((path / "manifest.json").read_text())
    return {k: np.load(path / f"arr_{i:05d}__shard0.npy")
            for i, k in enumerate(man["keys"])}


def measures(got: dict, want: dict) -> list:
    """(norm of the difference over the norm, largest difference over the
    largest magnitude, key) of each leaf, worst first."""
    import numpy as np
    rows = []
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        d = np.asarray(got[k], np.float64) - w
        rows.append((float(np.linalg.norm(d) / max(np.linalg.norm(w), 1e-30)),
                     float(np.abs(d).max() / max(np.abs(w).max(), 1e-30)), k))
    return sorted(rows, key=lambda t: -max(t[0], t[1]))


def worst(rows: list) -> float:
    return max((max(a, b) for a, b, _ in rows), default=0.0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class Launch:
    """One run of ``main``: ``hosts`` launchers of ``D * M / hosts`` ranks
    each, started at once, whose ranks wait for the gate."""

    label: str
    shape: tuple
    hosts: int
    out: Path
    ckpt: Path
    role: str
    argv: list
    raises: bool = False
    ref: "Launch | None" = None     # the reference it is held against
    result: "dict | None" = None    # what check() found
    procs: list = dataclasses.field(default_factory=list)

    def start(self, device: str) -> None:
        n = self.shape[0] * self.shape[1]
        per = n // self.hosts
        port = free_port() if self.hosts > 1 else None
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   TRAIN_OVER_CARDS_PID=str(os.getpid()))
        for h in range(self.hosts):
            lead = (["--standalone"] if self.hosts == 1 else
                    ["--nnodes", self.hosts, "--node-rank", h,
                     "--master-addr", "127.0.0.1", "--master-port", port])
            cmd = ([sys.executable, "-m", "torch.distributed.run"] + lead +
                   [f"--nproc-per-node={per}", __file__, "--child", self.out,
                    self.out.with_suffix(".go"),
                    f"{self.shape[0]}x{self.shape[1]}", self.role]
                   + self.argv)
            cards = {} if device != "cuda" or self.hosts == 1 else {
                "CUDA_VISIBLE_DEVICES": ",".join(
                    str(c) for c in range(h * per, (h + 1) * per))}
            self.procs.append(subprocess.Popen(
                [str(c) for c in cmd], env=dict(env, **cards), text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                start_new_session=True))

    def finish(self, timeout: float) -> tuple:
        """Open the gate and wait: ``(exit codes, host 0's output, every
        launcher's errors, seconds)``; killed past ``timeout``."""
        t0 = time.perf_counter()
        self.out.with_suffix(".go").touch()
        outs, errs, rcs = [], [], []
        for p in self.procs:
            try:
                o, e = p.communicate(
                    timeout=max(timeout - (time.perf_counter() - t0), 1.0))
            except subprocess.TimeoutExpired:
                self.kill()
                o, e = p.communicate()
                e += f"\nkilled after {timeout} s"
            outs.append(o)
            errs.append(e)
            rcs.append(p.returncode)
        return rcs, outs[0], errs, time.perf_counter() - t0

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)


def plan(args, tmp: Path) -> list:
    """The launches in order: the references, the runs, the restores."""
    meshes = [tuple(int(x) for x in m.split("x"))
              for m in args.meshes.split(",")]
    base = ["--preset", args.preset, "--steps", args.steps, "--batch",
            args.batch, "--seq", args.seq, "--ckpt-every", args.ckpt_every,
            "--device", args.device]

    def launch(label, shape, hosts, role, **kw):
        return Launch(label, shape, hosts, tmp / label, tmp / f"ck_{label}",
                      role, base + ["--ckpt-dir", tmp / f"ck_{label}"], **kw)

    runs = [launch(f"{d}x{m}h{h}", (d, m), h, "run", raises=d % h != 0)
            for d, m in meshes[1:]
            for h in (int(x) for x in args.hosts.split(","))
            if d * m % h == 0]
    source = next((r for r in runs if r.hosts > 1 and not r.raises), None)
    restores = source is not None and args.ckpt_every < args.steps
    refs = {}
    for h in sorted({r.hosts for r in runs if not r.raises} or {1}):
        until = args.ckpt_every if restores and h == source.hosts \
            else args.steps
        refs[h] = launch(f"ref_h{h}", meshes[0], 1, f"ref:{h}:{until}")
    for r in runs:
        r.ref = refs.get(r.hosts)
    if restores:
        runs += [launch(f"restore{d}x{m}", (d, m), 1,
                        f"restore:{tmp / f'dump{d}x{m}'}",
                        ref=refs[source.hosts]) for d, m in meshes]
    return list(refs.values()) + runs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--meshes", default="1x1,1x2,1x4",
                    help="DxM meshes, the first the reference (one card)")
    ap.add_argument("--hosts", default="1",
                    help="launcher counts each mesh runs from (e.g. 1,2)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", default="100m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-every", type=int,
                    help="the trainer's checkpoint interval (default: "
                         "--steps, one checkpoint at the end)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--tol", type=float, default=1e-2,
                    help="the first-step gradient leaves' bound")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a launch may run once its gate opens")
    ap.add_argument("--child", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    if args.child:
        child(*args.child[:4], args.child[4:])
        return
    args.ckpt_every = args.ckpt_every or args.steps
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    nccl = {k: v for k, v in os.environ.items() if k.startswith("NCCL_")}
    print(f"NCCL settings in the environment: {nccl or 'none'}")
    work = os.environ.get("TMPDIR") or ROOT / "build"   # gradients, ckpts
    Path(work).mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        runs = plan(args, Path(tmp))
        try:
            results = drive(args, runs)
        finally:
            for r in runs:
                r.kill()
    smi = ""
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        print(smi)
    ok = len(results) == len(runs) and all(r["ok"] for r in results)
    print(json.dumps({"ok": ok, "runs": results, "card": smi}))
    sys.exit(0 if ok else 1)


def drive(args, runs: list) -> list:
    """Start, run and check each launch in turn (module docstring); stops
    at a reference that fails."""
    results, started = [], 0
    for i, r in enumerate(runs):
        while started < min(i + 1 + AHEAD, len(runs)):
            runs[started].start(args.device)
            started += 1
        if r.role.startswith("restore:"):   # the source's checkpoint
            name = f"step_{args.ckpt_every:08d}"
            shutil.copytree(source_of(runs).ckpt / name, r.ckpt / name)
        rcs, out, errs, secs = r.finish(args.timeout)
        res = r.result = {"run": r.label, "mesh": list(r.shape),
                          "hosts": r.hosts, "seconds": secs}
        results.append(res)
        if r.raises:
            said = any(PLACE_ROWS_ERROR in e for e in errs)
            res["ok"] = any(rcs) and said
            print(f"{r.label}: data {r.shape[0]} over {r.hosts} hosts "
                  f"{'raised' if said else 'did not raise'} place_rows's "
                  f"error; exits {rcs}; {secs:.3f} s from its gate")
        elif any(rcs):
            res["ok"] = False
            print(f"{r.label}: exits {rcs}\n" +
                  "\n".join(e[-3000:] for e in errs))
        else:
            res.update(check(args, r, out, secs, runs))
        if r.role.startswith("ref:") and not res["ok"]:
            break
    return results


def settings_of(ranks: list) -> dict:
    """Rank 0's :func:`settings` and whether every rank's agree."""
    got = [{k: r.get(k) for k in SETTINGS} for r in ranks]
    return {"settings": got[0], "settings_agree": got == got[:1] * len(got)}


def source_of(runs: list) -> Launch:
    """The run whose middle checkpoint the restores start from."""
    return next(x for x in runs if x.role == "run" and x.hosts > 1
                and not x.raises)


def check(args, r: Launch, out: str, secs: float, runs: list) -> dict:
    """The gates and prints of one launch (module docstring)."""
    import numpy as np
    d, m = r.shape
    ranks = [json.loads(Path(f"{r.out}.r{k}.json").read_text())
             for k in range(d * m)]
    rep = ranks[0]
    head = [ln for ln in out.splitlines() if ln.startswith("arch=")]
    ok = bool(head) and head[0].endswith(
        f"mesh={{'data': {d}, 'model': {m}}}") and bool(rep["losses"]) \
        and bool(np.isfinite(rep["losses"]).all())
    ms = float(np.median(rep["step_s"][1:] or rep["step_s"])) * 1e3
    mem = [k.get("max_memory_allocated") for k in ranks]
    res = {"mesh_line": head[0] if head else None, "losses": rep["losses"],
           "step_ms": [t * 1e3 for t in rep["step_s"]],
           "median_step_ms": ms, "max_memory_allocated": mem}
    print(f"{r.label}: {res['mesh_line']}; {r.hosts} launcher(s); median "
          f"step {ms:.3f} ms (first {rep['step_s'][0] * 1e3:.3f} ms); "
          f"losses {[round(x, 6) for x in rep['losses']]}"
          + ("; max_memory_allocated by rank " + ", ".join(
              f"{b / 1e9:.3f}" for b in mem) + " GB" if None not in mem
             else "") + f"; {secs:.3f} s from its gate")
    g = dict(np.load(f"{r.out}.npz"))
    loss = float(g.pop("loss"))
    if r.role.startswith("ref:"):
        f32 = dict(np.load(f"{r.out}.f32.npz"))
        loss32 = float(f32.pop("loss"))
        floor = measures(g, f32)
        res.update(ok=ok, first_loss=loss, floor=worst(floor),
                   loss_floor=abs(loss - loss32) / abs(loss32))
        halves = measures(dict(np.load(f"{r.out}.halves.npz")), f32)
        res["halves_floor"] = worst(halves)
        f64 = dict(np.load(f"{r.out}.f64.npz"))
        loss64 = float(f64.pop("loss"))
        f32_f64 = measures(f32, f64)
        res.update(float64_loss=loss64, f32_from_float64=worst(f32_f64),
                   f32_loss_from_float64=abs(loss32 - loss64) / abs(loss64),
                   f32_from_float64_rows=f32_f64[:3],
                   **settings_of(ranks))
        print(f"  the floor: against the same step without bf16 (float32, "
              f"attention probabilities unrounded), its loss within "
              f"{res['loss_floor']:.3g} and its gradient within "
              f"{res['floor']:.3g}, worst {floor[:3]}; without bf16, the "
              f"mean of its batch's two halves' gradients (a data axis's "
              f"split of the sums over rows) within {worst(halves):.3g}, "
              f"worst {halves[:3]}")
        print(f"  float32's own error: the step without bf16 against the "
              f"same step in float64, its loss within "
              f"{res['f32_loss_from_float64']:.3g} and its gradient within "
              f"{worst(f32_f64):.3g}, worst {f32_f64[:3]}; {res['settings']}")
        return res
    ref = r.ref
    until = int(ref.role.rsplit(":", 1)[1])     # its batches are the run's
    ref_rep = json.loads(Path(f"{ref.out}.r0.json").read_text())
    res["ref_median_step_ms"] = float(np.median(
        ref_rep["step_s"][1:] or ref_rep["step_s"])) * 1e3
    if r.role == "run":
        rows = [k["rows"] for k in ranks]
        g0 = dict(np.load(f"{ref.out}.npz"))
        loss0 = float(g0.pop("loss"))
        loss_rel = abs(loss - loss0) / abs(loss0)
        grads = measures(g, g0)
        n = min(len(rep["losses"]), len(ref_rep["losses"]), until)
        later = float(np.max(np.abs(np.subtract(
            rep["losses"][:n], ref_rep["losses"][:n])) /
            np.abs(ref_rep["losses"][:n])))
        tokens = all(np.array_equal(np.load(f"{r.out}.h{h}.npz")[s], v)
                     for h in range(r.hosts)
                     for s, v in np.load(f"{ref.out}.h{h}.npz").items())
        u0 = dict(np.load(f"{ref.out}.f32.npz"))
        u = dict(np.load(f"{r.out}.f32.npz"))
        u_loss0, u_loss = float(u0.pop("loss")), float(u.pop("loss"))
        unrounded = measures(u, u0)
        u_loss_rel = abs(u_loss - u_loss0) / abs(u_loss0)
        f0 = dict(np.load(f"{ref.out}.f64.npz"))
        f = dict(np.load(f"{r.out}.f64.npz"))
        f_loss0, f_loss = float(f0.pop("loss")), float(f.pop("loss"))
        f64 = measures(f, f0)
        f64_loss_rel = abs(f_loss - f_loss0) / abs(f_loss0)
        truth = measures(u, f0)     # this run's float32 step from float64
        ok &= (rows == [args.batch // d] * (d * m) and loss_rel <= 1e-5
               and worst(grads) <= args.tol and tokens
               and u_loss_rel <= 1e-5 and worst(unrounded) <= UNROUNDED_TOL
               and f64_loss_rel <= F64_LOSS_TOL and worst(f64) <= F64_TOL)
        each = [max(a, b) for a, b, _ in grads]
        above = sum(x > args.tol for x in each)
        res.update(rows=rows, loss_rel=loss_rel, grad_worst=worst(grads),
                   grad_median=float(np.median(each)), grad_above=above,
                   grad_bound=args.tol,
                   grad_rows=grads[:3], later_losses_rel=later,
                   tokens_bitwise=tokens, unrounded_loss_rel=u_loss_rel,
                   unrounded_grad_worst=worst(unrounded),
                   unrounded_rows=unrounded[:3],
                   float64_loss_rel=f64_loss_rel,
                   float64_grad_worst=worst(f64), float64_rows=f64[:3],
                   unrounded_from_float64=worst(truth),
                   unrounded_from_float64_rows=truth[:3],
                   **settings_of(ranks))
        print(f"  against {ref.label}: rows {rows} (want {args.batch // d} "
              f"each); the first loss within {loss_rel:.3g} (bound 1e-05); "
              f"its gradient leaves within {worst(grads):.3g} (bound "
              f"{args.tol:g}; {above} of {len(each)} leaves above it, the "
              f"median leaf {res['grad_median']:.3g}), worst {grads[:3]}; "
              f"the first {n} losses within {later:.3g}; each host's rows of "
              f"steps 0 and 1 {'bitwise' if tokens else 'NOT bitwise'} "
              f"{ref.label}'s; median step {ms:.3f} ms against "
              f"{res['ref_median_step_ms']:.3f}")
        print(f"  the same step without bf16 on both: the first loss within "
              f"{u_loss_rel:.3g} (bound 1e-05), the gradient leaves within "
              f"{worst(unrounded):.3g} (bound {UNROUNDED_TOL:g}), worst "
              f"{unrounded[:3]}; against {ref.label}'s float64 step "
              f"{worst(truth):.3g} ({ref.label}'s own "
              f"{ref.result['f32_from_float64']:.3g}), worst "
              f"{truth[:3]}")
        print(f"  the same step in float64 on both: the first loss within "
              f"{f64_loss_rel:.3g} (bound {F64_LOSS_TOL:g}), the gradient "
              f"leaves within {worst(f64):.3g} (bound {F64_TOL:g}), worst "
              f"{f64[:3]}; {res['settings']}")
    else:                                       # a restore
        mid = args.ckpt_every
        src = leaves(source_of(runs).ckpt / f"step_{mid:08d}")
        back = leaves(Path(r.role.partition(":")[2]) / f"step_{mid:08d}")
        bitwise = list(back) == list(src) and all(
            back[k].dtype == src[k].dtype and np.array_equal(back[k], src[k])
            for k in src)
        ok &= (bitwise and rep["resumed_from"] == mid
               and rep["steps_run"] == args.steps - mid)
        res.update(restored_bitwise=bitwise, resumed_from=rep["resumed_from"])
        print(f"  restored from step {mid} of {source_of(runs).label}: its "
              f"{len(src)} leaves {'bitwise' if bitwise else 'NOT bitwise'} "
              f"the files; resumed_from={rep['resumed_from']}, "
              f"{rep['steps_run']} steps")
    name = f"step_{args.steps:08d}"
    if (r.ckpt / name).exists() and (r.role != "run" or until == args.steps):
        last = measures(leaves(r.ckpt / name), leaves(ref.ckpt / name))
        res.update(last_worst=worst(last), last_rows=last[:3])
        if r.role != "run":
            ok &= worst(last) <= RESTORE_TOL
        print(f"  {name}'s leaves within {worst(last):.3g} of {ref.label}'s"
              + (f" (bound {RESTORE_TOL:g})" if r.role != "run" else "")
              + f", worst {last[:3]}")
    res["ok"] = bool(ok)
    return res


if __name__ == "__main__":
    main()
