"""Fault-tolerant training loop (port of ``repro.train.trainer``).

Production behaviors, all testable on one CPU process:

* auto-resume from the latest complete checkpoint (atomic commits mean a
  killed run can never resume from a torn snapshot)
* SIGTERM/SIGINT → synchronous save → clean exit (preemption handling)
* NaN/Inf guard: count bad steps (the new state is adopted, as in the
  reference, whose donated buffers leave no old state to keep); halt after
  ``max_bad_steps`` consecutive bad steps
* step-time watchdog: rolling p50; steps slower than ``straggler_factor``×p50
  are logged as straggler events, with the host's index as ``host``
* deterministic data order keyed by (seed, step) so restart ≡ no-failure run

In a process group (``torchrun``, one rank per device) every rank runs the
loop on its shards of a placed model: the stop flag is agreed each step by
a MAX all-reduce, so a signal that reaches the ranks at different steps
still stops them all after the same step, which they save together; the
checkpoint calls are collective (``checkpoint``); lines are printed on
rank 0 only.

The step runs eagerly on the model it is given (a
:class:`~repro_torch.models.transformer.Transformer`), which it updates in
place; each step is timed behind ``torch.cuda.synchronize()`` where CUDA
is present.  A checkpoint holds ``(param_tree(model), opt_state)`` in the
reference's layout, and a resume writes the restored parameters into the
model.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.data.tokens import process_rank_and_count
from repro_torch.distributed.sharding import rank_and_size, whole
from repro_torch.models.weights import param_tree
from .checkpoint import CheckpointManager


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    ckpt_keep: int = 3
    log_every: int = 10
    max_bad_steps: int = 10
    straggler_factor: float = 3.0
    async_ckpt: bool = True
    seed: int = 0


@dataclasses.dataclass
class TrainerReport:
    steps_run: int = 0
    resumed_from: int | None = None
    bad_steps: int = 0
    straggler_events: list = dataclasses.field(default_factory=list)
    losses: list = dataclasses.field(default_factory=list)
    step_times: list = dataclasses.field(default_factory=list)
    interrupted: bool = False


class Trainer:
    def __init__(self, cfg: TrainerConfig,
                 train_step: Callable[[Any, Any, dict], tuple[Any, Any, dict]],
                 data_fn: Callable[[int], dict],
                 sharding_fn: Callable[[Any], Any] | None = None):
        self.cfg = cfg
        self.train_step = train_step
        self.data_fn = data_fn              # step → batch (deterministic)
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep)
        self.sharding_fn = sharding_fn
        self._stop = False

    def _stopping(self) -> bool:
        """The stop flag, agreed by every rank of a process group (a MAX
        all-reduce on the group's device)."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            return self._stop
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        flag = torch.tensor([int(self._stop)], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        agreed = bool(flag.item())
        if agreed:              # a rank's own signal is never cleared here
            self._stop = True
        return agreed

    def _install_signals(self):
        def handler(signum, frame):
            self._stop = True
        self._prev = {s: signal.signal(s, handler)
                      for s in (signal.SIGTERM, signal.SIGINT)}

    def _restore_signals(self):
        for s, h in self._prev.items():
            signal.signal(s, h)

    def _save(self, step: int, model, opt_state, blocking: bool) -> None:
        self.ckpt.save(step, (param_tree(model), opt_state),
                       extras={"next_step": step}, blocking=blocking)

    def run(self, model, opt_state: Any) -> tuple[Any, Any, TrainerReport]:
        cfg = self.cfg
        report = TrainerReport()
        start = 0

        latest = self.ckpt.latest_step()
        if latest is not None:
            params = param_tree(model)
            (saved, opt_state), extras = self.ckpt.restore(
                latest, (params, opt_state), self.sharding_fn)
            _assign(params, saved)
            start = int(extras.get("next_step", latest))
            report.resumed_from = latest

        self._install_signals()
        times: deque[float] = deque(maxlen=50)
        consecutive_bad = 0
        step = start
        try:
            while step < cfg.total_steps and not self._stopping():
                batch = self.data_fn(step)
                t0 = time.perf_counter()
                model, opt_state, metrics = self.train_step(
                    model, opt_state, batch)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                loss = float(whole(metrics["loss"]))
                dt = time.perf_counter() - t0
                times.append(dt)
                report.step_times.append(dt)

                if not np.isfinite(loss):
                    # NaN guard: the update is already in the model (the
                    # reference adopts the new state too; checkpoint-based
                    # rollback is the real-world path); halt if persistent
                    consecutive_bad += 1
                    report.bad_steps += 1
                    if consecutive_bad >= cfg.max_bad_steps:
                        raise FloatingPointError(
                            f"{consecutive_bad} consecutive non-finite losses")
                else:
                    consecutive_bad = 0
                    report.losses.append(loss)

                p50 = float(np.median(times))
                if len(times) >= 10 and dt > cfg.straggler_factor * p50:
                    report.straggler_events.append(
                        {"step": step, "dt": dt, "p50": p50,
                         "host": process_rank_and_count()[0]})

                step += 1
                report.steps_run += 1
                if step % cfg.ckpt_every == 0:
                    self._save(step, model, opt_state,
                               blocking=not cfg.async_ckpt)
                if step % cfg.log_every == 0 and rank_and_size()[0] == 0:
                    print(f"step {step}: loss={loss:.4f} dt={dt*1e3:.0f}ms",
                          flush=True)
        finally:
            self._restore_signals()

        if self._stopping():
            report.interrupted = True
            self._save(step, model, opt_state, blocking=True)
        self.ckpt.wait()
        return model, opt_state, report


@torch.no_grad()
def _assign(params: Any, saved: Any) -> None:
    """Write the restored leaves of ``saved`` into the parameters."""
    if isinstance(params, dict):
        for k in params:
            _assign(params[k], saved[k])
    elif isinstance(params, list):
        for p, s in zip(params, saved):
            _assign(p, s)
    else:
        params.copy_(saved)
