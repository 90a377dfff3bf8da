"""Architecture registry: name → config + step functions (port of
``repro.models.registry``).

A batch is a dict of tensors: ``tokens [B, S]`` (integer), plus
``frames`` for the enc-dec family and ``patches`` for the VLM.
:func:`input_specs` gives one run cell's batch as fake tensors and
:func:`batch_logical` its logical names, for the dry run.
"""
from __future__ import annotations

import importlib
from typing import Any

import torch

from repro_torch.configs.base import (ArchConfig, RunShape, SHAPES,
                                      cell_applicable)
from repro_torch.distributed.sharding import get_device_mesh, local, shard
from . import transformer as tfm
from .common import work_dtype

_CONFIG_MODULES = {
    "whisper-base": "whisper_base",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b_a66b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "llama3-405b": "llama3_405b",
    "olmo-1b": "olmo_1b",
    "qwen3-32b": "qwen3_32b",
    "xlstm-1.3b": "xlstm_1_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
}

ARCH_NAMES = list(_CONFIG_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _CONFIG_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_CONFIG_MODULES[name]}")
    return mod.CONFIG


def input_specs(cfg: ArchConfig, shape: RunShape,
                device: str | torch.device = "cuda") -> dict[str, Any]:
    """The batch of one run cell as fake tensors (the reference's
    ``ShapeDtypeStruct`` batch): int32 tokens, frames or patches in the
    compute dtype; for decode one token, the position (a 0-d int32) and
    the caches sized for the cell's sequence (stacked layout)."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.device_index import resolve_device
    from .common import DTYPES
    device = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    cd = DTYPES[cfg.compute_dtype]
    mode = detect_fake_mode() or FakeTensorMode()
    with mode:
        def t(shp, dt):
            return torch.empty(shp, dtype=dt, device=device)
        if shape.kind in ("train", "prefill"):
            batch: dict[str, Any] = {"tokens": t((B, S), torch.int32)}
            if cfg.family == "encdec":
                batch["frames"] = t((B, cfg.encoder_seq, cfg.d_model), cd)
            if cfg.family == "vlm":
                batch["patches"] = t((B, cfg.vision_tokens, cfg.d_model), cd)
            return batch
        return {"token": t((B, 1), torch.int32), "pos": t((), torch.int32),
                "cache": tfm.abstract_cache(cfg, B, S, device)}


def batch_logical(cfg: ArchConfig, shape: RunShape) -> dict[str, Any]:
    """Logical axis names of every input of :func:`input_specs`."""
    from .common import logical_tree
    if shape.kind in ("train", "prefill"):
        out: dict[str, Any] = {"tokens": ("batch", "seq")}
        if cfg.family == "encdec":
            out["frames"] = ("batch", "frames", None)
        if cfg.family == "vlm":
            out["patches"] = ("batch", "patches", None)
        return out
    return {"token": ("batch", None), "pos": (),
            "cache": logical_tree(tfm.cache_specs(cfg, shape.global_batch,
                                                  shape.seq_len))}


# ---------------------------------------------------------------------------
# step functions (model-level; optimizer wrapping belongs to training)
# ---------------------------------------------------------------------------

def loss_fn(model: tfm.Transformer, batch: dict) -> torch.Tensor:
    """Next-token cross entropy, float32 logsumexp over the vocab (float64
    for a float64 model, ``common.work_dtype``).  The
    target's logit is picked by a gather, which equals the reference's
    iota-mask sum exactly (one term is nonzero); on a ``DeviceMesh`` by
    that sum itself (:func:`_loss_on_mesh`)."""
    logits = tfm.forward_train(model, batch)
    logits = logits.to(work_dtype(logits))
    targets = batch["tokens"][:, 1:].long()
    if get_device_mesh() is not None:
        return _loss_on_mesh(logits, targets)
    logits = logits[:, :-1, :]
    lse = _LogSumExp.apply(logits)
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - picked).mean()


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dimension, whose backward builds
    ``g · exp(x - lse)`` in one ``[.., V]`` buffer updated in place: the
    same values as autograd's formula, which makes three (the difference,
    its exponential and the product)."""

    @staticmethod
    def forward(ctx, x):
        lse = torch.logsumexp(x, dim=-1)
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return (x - lse[..., None]).exp_().mul_(g[..., None])


def _loss_on_mesh(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """:func:`loss_fn` on DTensor logits sharded over the vocabulary, kept
    to each device's shard as the reference's compiler keeps it: the last
    position cut from each device's own shard (DTensor's slice gathers
    the vocabulary back in the backward pass), the target's logit picked
    by the reference's iota-mask sum, the logsumexp as a max and a sum of
    exponentials reduced across the shards, and the per-position terms
    placed as the batch (so the mean's gradient reaches each device as its
    own rows, not expanded whole).  Each is the plain op where the
    vocabulary is not split."""
    from torch.distributed.tensor import DTensor, Replicate
    names = ("batch", "seq", "vocab")
    logits = local(lambda t: t[:, :-1, :], (names,), names)(logits)
    mesh = logits.device_mesh
    # the iota placed as the vocabulary, so each device compares its own
    # columns and no [B, S, V] mask of the whole vocabulary is made
    vocab = shard(DTensor.from_local(
        torch.arange(logits.shape[-1], device=logits.device), mesh,
        (Replicate(),) * mesh.ndim, run_check=False), "vocab")
    hit = shard(vocab == targets[..., None], *names)
    picked = shard(torch.where(hit, logits, 0.0).sum(-1), "batch", "seq")
    if any(p.is_shard() and p.dim == 2 and size > 1
           for p, size in zip(logits.placements, mesh.shape)):
        m = logits.detach().amax(-1, keepdim=True)
        total = shard(torch.exp(logits - m).sum(-1), "batch", "seq")
        lse = torch.log(total) + m[..., 0]
    else:
        lse = _LogSumExp.apply(logits)
    return shard(lse - picked, "batch", "seq").mean()


def make_eval_step(cfg: ArchConfig):
    def eval_step(model, batch):
        return loss_fn(model, batch)
    return eval_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(model, batch):
        return tfm.forward_prefill(model, batch)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def serve_step(model, batch):
        return tfm.forward_decode(model, batch["cache"], batch["token"],
                                  batch["pos"])
    return serve_step


def applicable_cells(name: str) -> list[tuple[str, bool, str]]:
    cfg = get_config(name)
    return [(s.name, *cell_applicable(cfg, s)) for s in SHAPES.values()]
