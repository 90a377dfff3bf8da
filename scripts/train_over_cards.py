"""``launch.train.main`` on 1, 2, ... ranks of one CUDA card each, held
against one rank.

    python3 scripts/train_over_cards.py --ranks 1,2,4      # a 4-GPU machine
    python3 scripts/train_over_cards.py --ranks 1,2,4 --preset smoke \\
        --batch 8 --seq 128 --tol 1e-4
    python3 scripts/train_over_cards.py --device cpu --preset smoke \\
        --batch 4 --seq 16 --ranks 1,2 --tol 1e-4          # gloo rehearsal

For each rank count ``n`` the script runs ``torchrun --standalone
--nproc-per-node n -m repro_torch.launch.train`` (NCCL, one card a rank)
on the same preset, batch, length and steps with a checkpoint at the end,
each rank in a child of this script that records rank 0's trainer report.
Each run also writes its first step's loss and gradients, gathered
whole, before any update.  It prints each run's ``mesh=`` line, median
step ms and losses, and, against the first rank count: the first step's
loss, each gradient leaf's norm of the difference over its norm and
largest difference over its largest magnitude (worst first), the largest
relative difference of the later losses, and the same two measures for
every parameter and AdamW moment leaf of the last checkpoint; then the
cards' names and power limits.  It exits non-zero if a run fails, a loss
is not finite, the first loss is further than 1e-5 from the first run's
or a first-step gradient leaf further than ``--tol`` by either measure:
1e-2 by default, three times the ``100m`` gradient's own floor (it moves
3.4e-3 of its norm between 1 and 4 CPU threads: its attention rounds
probabilities and their cotangents to bf16 even in float32); 1e-4, the
bound of ``tests/test_torch_train_mesh.py`` for a placed step on gloo
ranks, for the float32 ``smoke`` preset.  The later losses and the
checkpoint are printed, not held: ranks add partial sums in another
order, and the ``100m`` preset's AdamW (a grad norm ~59 clipped to 1,
``m / sqrt(v)`` of near-zero gradients) turns one ulp of one gradient
into 1.6e-4 of the loss by the fourth step
(``scripts/probe_placed_step.py``, NVIDIA H100 80GB HBM3, 700.00 W).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(out: str, argv: list) -> None:
    """One rank: ``main(argv)``, rank 0's report written to ``out`` and
    the first step's loss and gradients, whole, to ``out``'s ``.npz``."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch.distributed.sharding import whole
    from repro_torch.launch import train
    from repro_torch.train import train_step, trainer
    torch.use_deterministic_algorithms(True, warn_only=True)
    run, first = trainer.Trainer.run, train_step._loss_and_grads

    def loss_and_grads(model, batch):
        loss, grads = first(model, batch)
        if train_step._loss_and_grads is loss_and_grads:   # once
            train_step._loss_and_grads = first
            arrays = {k: whole(g).float().cpu().numpy()
                      for k, g in named(grads)}
            if os.environ.get("RANK", "0") == "0":
                np.savez(Path(out).with_suffix(".npz"), **arrays,
                         loss=float(loss))
        return loss, grads
    train_step._loss_and_grads = loss_and_grads

    def recorded(self, model, opt_state):
        model, opt_state, rep = run(self, model, opt_state)
        if os.environ.get("RANK", "0") == "0":
            Path(out).write_text(json.dumps({
                "losses": rep.losses, "step_s": rep.step_times}))
        return model, opt_state, rep
    trainer.Trainer.run = recorded
    train.main(argv)


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
    import numpy as np
    man = json.loads((path / "manifest.json").read_text())
    return {k: np.load(path / f"arr_{i:05d}__shard0.npy").astype(np.float64)
            for i, k in enumerate(man["keys"])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", default="100m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--tol", type=float, default=1e-2)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--child", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    if args.child:
        child(args.child[0], args.child[1:])
        return
    import numpy as np
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    runs, bad = {}, False
    with tempfile.TemporaryDirectory(dir=ROOT / "build"
                                     if (ROOT / "build").is_dir() else None
                                     ) as tmp:
        for n in [int(x) for x in args.ranks.split(",")]:
            ck, rep = Path(tmp) / f"ck{n}", Path(tmp) / f"r{n}.json"
            argv = ["--preset", args.preset, "--steps", args.steps,
                    "--batch", args.batch, "--seq", args.seq,
                    "--ckpt-every", args.steps, "--ckpt-dir", ck,
                    "--device", args.device]
            cmd = [sys.executable, "-m", "torch.distributed.run",
                   "--standalone", f"--nproc-per-node={n}", __file__,
                   "--child", rep] + argv
            proc = subprocess.Popen(
                [str(c) for c in cmd], text=True, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, start_new_session=True,
                env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
            try:
                out, err = proc.communicate(timeout=args.timeout)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                out, err = proc.communicate()
                print(f"{n} ranks: killed after {args.timeout} s")
                bad = True
                continue
            if proc.returncode != 0:
                print(f"{n} ranks: exit {proc.returncode}\n{err[-3000:]}")
                bad = True
                continue
            r = json.loads(rep.read_text())
            head = [ln for ln in out.splitlines() if ln.startswith("arch=")]
            ms = float(np.median(r["step_s"][1:])) * 1e3
            g = dict(np.load(rep.with_suffix(".npz")))
            runs[n] = (r, leaves(ck / f"step_{args.steps:08d}"), g)
            print(f"{n} ranks: {head[0] if head else '(no header)'}; median "
                  f"step {ms:.3f} ms (first {r['step_s'][0] * 1e3:.3f} ms); "
                  f"losses {[round(x, 6) for x in r['losses']]}")
    def measures(got: dict, want: dict) -> list:
        """(norm of the difference over the norm, largest difference over
        the largest magnitude, key) of each leaf, worst first."""
        rows = []
        for k, w in want.items():
            d = got[k].astype(np.float64) - w
            rows.append((float(np.linalg.norm(d) / max(np.linalg.norm(w),
                                                        1e-30)),
                         float(np.abs(d).max() / max(np.abs(w).max(),
                                                     1e-30)), k))
        return sorted(rows, key=lambda t: -max(t[0], t[1]))

    if runs:
        first = min(runs)
        r0, c0, g0 = runs[first]
        loss0 = float(g0.pop("loss"))
        for n, (r, c, g) in sorted(runs.items()):
            if n == first:
                continue
            loss_rel = abs(float(g.pop("loss")) - loss0) / abs(loss0)
            grads = measures(g, g0)
            worst_g = max(max(a, b) for a, b, _ in grads)
            rel = float(np.max(np.abs(np.subtract(r["losses"], r0["losses"]))
                               / np.abs(r0["losses"])))
            bad |= (loss_rel > 1e-5 or worst_g > args.tol
                    or not np.isfinite(r["losses"]).all())
            ck = measures(c, c0)
            print(f"{n} ranks against {first}: the first step's loss within "
                  f"{loss_rel:.3g} (bound 1e-05), its gradient leaves within "
                  f"{worst_g:.3g} (bound {args.tol:g}), worst {grads[:3]}; "
                  f"the {len(r['losses'])} losses within {rel:.3g}; the "
                  f"last checkpoint's leaves within "
                  f"{max(max(a, b) for a, b, _ in ck):.3g}, worst {ck[:3]}")
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    sys.exit(1 if bad or not runs else 0)


if __name__ == "__main__":
    main()
