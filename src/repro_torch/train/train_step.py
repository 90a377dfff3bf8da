"""Train-step builders (port of ``repro.train.train_step``): loss →
``backward`` → clip → AdamW, as one eager function over
``(model, opt_state, batch)``.

The step runs on the model it is given and updates its parameters in
place (there is no ``jax.jit`` with donated buffers); gradients are
zeroed at the start of each step, never carried over from the last.  A
batch is a dict of numpy arrays or tensors; it is moved to the model's
device here.

On a model placed on a ``DeviceMesh`` (``models.weights.place_model``,
under ``logical_rules``) the step runs under DTensor's implicit
replication of the plain tensors the model makes (its constants); each
rank keeps its own rows of its host's batch (``sharding.place_rows``,
the ``("batch", ...)`` placement), and the loss comes back whole.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import process_rank_and_count
from repro_torch.distributed.sharding import (batch_rows, is_dtensor, like,
                                              place_rows, whole)
from repro_torch.models.common import DTYPES, leaves, map_tree, zip_tree
from repro_torch.models.registry import loss_fn
from repro_torch.models.weights import param_tree
from . import optimizer as opt


def to_device(batch: dict, device: torch.device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _mesh(model):
    """The ``DeviceMesh`` a placed model lives on, or ``None``."""
    return getattr(model.embed, "device_mesh", None)


def _model_batch(model, batch: dict) -> dict:
    """The batch on the model's device; on a placed model, each rank's
    rows of it placed as ``("batch", ...)`` (a batch placed already, as
    the dry run's, as it is)."""
    batch = to_device(batch, model.embed.device)
    mesh = _mesh(model)
    if mesh is None:
        return batch
    host, hosts = process_rank_and_count()
    return {k: v if is_dtensor(v) else
            place_rows(v, ("batch",) + (None,) * (v.ndim - 1), mesh, host,
                       hosts) for k, v in batch.items()}


def _placed(model):
    """DTensor's implicit replication on a placed model, else nothing."""
    if _mesh(model) is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


@contextlib.contextmanager
def _grads_placed_as_made(model):
    """On a placed model, each gradient redistributed to its parameter's
    placements as soon as the backward pass has accumulated it (as the
    reference's compiler reduces a weight's gradient where it is made), so
    the partial gradients of every layer are not all held at once; nothing
    without a mesh."""
    if _mesh(model) is None:
        yield
        return

    def hook(p):
        p.grad = like(p.grad, p)
    handles = [p.register_post_accumulate_grad_hook(hook)
               for p in model.parameters()]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _loss_and_grads(model, batch: dict) -> tuple[torch.Tensor, dict]:
    model.zero_grad(set_to_none=True)
    with _placed(model), _grads_placed_as_made(model):
        loss = loss_fn(model, batch)
        loss.backward()
    # a gradient in its parameter's placements (DTensor may return one
    # partial or otherwise placed)
    return whole(loss.detach()), zip_tree(
        like, param_tree(model, grads=True), param_tree(model))


def make_train_step(cfg: ArchConfig, ocfg: opt.AdamWConfig
                    ) -> Callable[[Any, dict, dict], tuple[Any, dict, dict]]:
    def train_step(model, opt_state, batch):
        batch = _model_batch(model, batch)
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
        batch = _model_batch(model, batch)
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
