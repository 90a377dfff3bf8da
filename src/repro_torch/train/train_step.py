"""Train-step builders (port of ``repro.train.train_step``): loss →
``backward`` → clip → AdamW, as one eager function over
``(model, opt_state, batch)``.

The step runs on the model it is given and updates its parameters in
place (there is no ``jax.jit`` with donated buffers); gradients are
zeroed at the start of each step, never carried over from the last.  A
batch is a dict of numpy arrays or tensors; it is moved to the model's
device here.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import batch_rows
from repro_torch.models.common import DTYPES, leaves, map_tree
from repro_torch.models.registry import loss_fn
from repro_torch.models.weights import param_tree
from . import optimizer as opt


def to_device(batch: dict, device: torch.device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _loss_and_grads(model, batch: dict) -> tuple[torch.Tensor, dict]:
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch)
    loss.backward()
    return loss.detach(), param_tree(model, grads=True)


def make_train_step(cfg: ArchConfig, ocfg: opt.AdamWConfig
                    ) -> Callable[[Any, dict, dict], tuple[Any, dict, dict]]:
    def train_step(model, opt_state, batch):
        batch = to_device(batch, model.embed.device)
        loss, grads = _loss_and_grads(model, batch)
        _, new_state, metrics = opt.apply(param_tree(model), grads,
                                          opt_state, ocfg)
        model.zero_grad(set_to_none=True)
        return model, new_state, dict(metrics, loss=loss)
    return train_step


def make_microbatched_train_step(cfg: ArchConfig, ocfg: opt.AdamWConfig,
                                 n_micro: int):
    """Gradient accumulation over ``n_micro`` microbatches (a sequential
    loop — for memory-bound cells; the activations' peak scales
    1/n_micro), summed in ``accum_dtype`` and divided by ``n_micro``; the
    loss reported is the microbatches' mean."""
    acc_dt = DTYPES[ocfg.accum_dtype]

    def train_step(model, opt_state, batch):
        batch = to_device(batch, model.embed.device)
        params = param_tree(model)
        acc = map_tree(lambda p: torch.zeros_like(p, dtype=acc_dt), params)
        per = batch["tokens"].shape[0] // n_micro
        losses = []
        for i in range(n_micro):
            mb = {k: batch_rows(v, i * per, (i + 1) * per)
                  for k, v in batch.items()}
            loss, grads = _loss_and_grads(model, mb)
            with torch.no_grad():
                for a, g in zip(leaves(acc), leaves(grads)):
                    a.add_(g.to(acc_dt))
            losses.append(loss)
        grads = map_tree(lambda a: a / n_micro, acc)
        _, new_state, metrics = opt.apply(params, grads, opt_state, ocfg)
        model.zero_grad(set_to_none=True)
        return model, new_state, dict(metrics,
                                      loss=torch.stack(losses).mean())
    return train_step
