"""Where a placed train step on a (1, 1) mesh departs from the plain one.

    python3 scripts/probe_placed_step.py                 # on a GPU machine
    python3 scripts/probe_placed_step.py --device cpu --preset smoke

On one rank (a process group of one: NCCL on the card, gloo on the CPU)
the script builds the ``launch.train`` preset's model from seed 0 twice,
plain and placed on the ``(1, 1)`` mesh (``models/weights.place_model``),
and runs ``--steps`` train steps of ``launch.train``'s optimizer on
``batch_at(0..)`` under ``torch.use_deterministic_algorithms`` (warning
only).  For the first step it prints the loss of each (and whether they
are bitwise), then each gradient leaf's largest difference over its
largest magnitude, worst first, and the number of leaves that are
bitwise; for every step the two losses and grad norms.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", default="100m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.distributed.sharding import (DEFAULT_RULES,
                                                  logical_rules, named_mesh)
    from repro_torch.launch.train import preset_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.weights import param_tree, place_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: this probe needs one NVIDIA GPU")
    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device(args.device, 0) if args.device == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    cfg = preset_config("olmo-1b", args.preset)
    ocfg = opt.AdamWConfig(lr=3e-4, total_steps=20, warmup_steps=5,
                           moment_dtype=cfg.moment_dtype)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))

    def fresh():
        return tfm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)

    def grads_of(model, batch):
        loss, g = ts._loss_and_grads(model, ts._model_batch(model, batch))
        flat = {}

        def walk(t, at):
            if isinstance(t, dict):
                for k in sorted(t):
                    walk(t[k], f"{at}/{k}")
            elif isinstance(t, list):
                for i, v in enumerate(t):
                    walk(v, f"{at}/{i}")
            else:
                flat[at] = (t.full_tensor() if hasattr(t, "full_tensor")
                            else t).float()
        walk(g, "")
        model.zero_grad(set_to_none=True)
        return float(loss), flat

    mesh = named_mesh((1, 1), ("data", "model"), dev.type)
    with logical_rules(mesh, DEFAULT_RULES):
        placed = place_model(fresh())
        pl_loss, pl_grads = grads_of(placed, pipe.batch_at(0))
    plain = fresh()
    p_loss, p_grads = grads_of(plain, pipe.batch_at(0))
    print(f"step 0 loss: plain {p_loss!r}, placed {pl_loss!r}, bitwise "
          f"{p_loss == pl_loss}")
    rows = []
    for k, g in p_grads.items():
        d = float((pl_grads[k] - g).abs().max())
        rows.append((d / max(float(g.abs().max()), 1e-30), d, k))
    rows.sort(reverse=True)
    print("gradient leaves, worst first (max |d| / max |g|, max |d|):")
    for r in rows[:8]:
        print(f"  {r[2]}: {r[0]:.3g}, {r[1]:.3g}")
    print(f"  bitwise leaves: {sum(r[1] == 0 for r in rows)} of {len(rows)}")

    with logical_rules(mesh, DEFAULT_RULES):
        placed = place_model(fresh())
        state_q = opt.init(param_tree(placed), ocfg)
    plain = fresh()
    state_p = opt.init(param_tree(plain), ocfg)
    step = ts.make_train_step(cfg, ocfg)
    for i in range(args.steps):
        batch = pipe.batch_at(i)
        plain, state_p, mp = step(plain, state_p, batch)
        with logical_rules(mesh, DEFAULT_RULES):
            placed, state_q, mq = step(placed, state_q, batch)
        print(f"step {i}: loss plain {float(mp['loss'])!r} placed "
              f"{float(mq['loss'])!r}; grad norm {float(mp['grad_norm'])!r}"
              f" / {float(mq['grad_norm'])!r}")
    dist.destroy_process_group()
    if dev.type == "cuda":
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())


if __name__ == "__main__":
    main()
