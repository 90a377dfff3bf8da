"""End-to-end training driver (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --preset smoke
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --preset 100m \\
        --steps 300 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20

Presets:
  smoke — reduced config (CPU-friendly, seconds)
  100m  — ~100M-parameter same-family config (the assignment's end-to-end
          driver scale; hours on CPU, minutes on real accelerators)
  full  — the assigned architecture as specified

Fault tolerance is live here: kill -TERM mid-run → checkpoint → rerun with
the same --ckpt-dir resumes where it left off.

Over several devices it runs one rank per device under ``torchrun``, as
the reference's one process runs over every device it sees:

    PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \\
        -m repro_torch.launch.train --arch olmo-1b --preset 100m

The ranks form the reference's ``(data, model)`` mesh (8 give
``{'data': 1, 'model': 8}``), place the model by ``DEFAULT_RULES`` and
restore checkpoints onto it with the reference's ``sharding_fn``; NCCL
on ``cuda:LOCAL_RANK``, or gloo with ``--device cpu``.  A lone process
trains on its one device without placement (a single process that sees
several CUDA devices refuses: start it under ``torchrun``).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import reduced
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.distributed.sharding import (DEFAULT_RULES, logical_rules,
                                              shardings_for)
from repro_torch.launch.mesh import make_host_mesh, make_rank_mesh, world
from repro_torch.models import registry, transformer as tfm
from repro_torch.models.weights import logical_names, param_tree, place_model
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def preset_config(arch: str, preset: str):
    cfg = registry.get_config(arch)
    if preset == "full":
        return cfg
    if preset == "smoke":
        return reduced(cfg)
    if preset == "100m":
        # ~100M same-family: scale width/depth down, keep the block pattern
        pat = len(cfg.block_pattern)
        return dataclasses.replace(
            reduced(cfg), n_layers=max(8 // pat, 1) * pat, d_model=512,
            n_heads=8, n_kv_heads=min(cfg.n_kv_heads, 8) or 1, head_dim=64,
            d_ff=2048 if cfg.d_ff else 0, vocab=32_768,
            rnn_dim=512 if cfg.rnn_dim else 0)
    raise ValueError(preset)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="the device to train on (cuda unless cpu is asked)")
    args = ap.parse_args(argv)

    cfg = preset_config(args.arch, args.preset)
    with world(args.device) as w:
        if not w.grouped and make_host_mesh(args.device).size > 1:
            raise RuntimeError(
                "several CUDA devices are visible to one process: start one "
                "rank per device under torchrun (--nproc-per-node), or make "
                "one device visible (CUDA_VISIBLE_DEVICES)")
        report = _train(args, cfg, w)
    if report.losses and w.rank == 0:
        k = max(len(report.losses) // 10, 1)
        print(f"done: steps={report.steps_run} "
              f"loss {np.mean(report.losses[:k]):.3f} → "
              f"{np.mean(report.losses[-k:]):.3f} "
              f"resumed_from={report.resumed_from} "
              f"stragglers={len(report.straggler_events)}")


def _train(args, cfg, w):
    """The reference's ``main`` body on this rank: the model placed on the
    ranks' mesh under ``DEFAULT_RULES`` in a process group, plain on a
    lone process."""
    mesh = make_rank_mesh(w.device) if w.grouped else None
    shape = (dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh is not None
             else {"data": 1, "model": 1})
    if w.rank == 0:
        print(f"arch={cfg.name} preset={args.preset} "
              f"params={tfm.count_params(cfg)/1e6:.1f}M mesh={shape}")

    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))

    def data_fn(step: int) -> dict:
        batch = pipe.batch_at(step)
        extra = {}
        if cfg.family == "encdec":
            extra["frames"] = np.zeros((args.batch, cfg.encoder_seq,
                                        cfg.d_model), np.float32)
        if cfg.family == "vlm":
            extra["patches"] = np.zeros((args.batch, cfg.vision_tokens,
                                         cfg.d_model), np.float32)
        return {**batch, **extra}

    with logical_rules(mesh, DEFAULT_RULES if mesh is not None else None):
        model = tfm.init_params(cfg, torch.Generator(w.device).manual_seed(0),
                                w.device)
        if mesh is not None:
            model = place_model(model)
        ocfg = opt.AdamWConfig(lr=args.lr, total_steps=args.steps,
                               warmup_steps=max(args.steps // 20, 5),
                               moment_dtype=cfg.moment_dtype)
        opt_state = opt.init(param_tree(model), ocfg)
        logical = logical_names(cfg)

        def sharding_fn(tree):
            return shardings_for(tree, (logical, opt.state_logical(logical)))

        trainer = Trainer(
            TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir),
            make_train_step(cfg, ocfg), data_fn,
            sharding_fn if mesh is not None else None)
        _, _, report = trainer.run(model, opt_state)
    return report


if __name__ == "__main__":
    main()
