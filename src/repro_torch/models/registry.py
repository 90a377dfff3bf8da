"""Architecture registry: name → config + step functions (port of
``repro.models.registry``).

The reference's ``input_specs`` and ``batch_logical`` are
``ShapeDtypeStruct`` stand-ins and logical names for its XLA dry run; a
torch program has no such lowering, so they are not ported.  A batch here
is a dict of tensors: ``tokens [B, S]`` (integer), plus ``frames`` for
the enc-dec family and ``patches`` for the VLM.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import ArchConfig, SHAPES, cell_applicable
from . import transformer as tfm

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


# ---------------------------------------------------------------------------
# step functions (model-level; optimizer wrapping belongs to training)
# ---------------------------------------------------------------------------

def loss_fn(model: tfm.Transformer, batch: dict) -> torch.Tensor:
    """Next-token cross entropy, float32 logsumexp over the vocab.  The
    target's logit is picked by a gather, which equals the reference's
    iota-mask sum exactly (one term is nonzero)."""
    logits = tfm.forward_train(model, batch).float()
    targets = batch["tokens"][:, 1:].long()
    logits = logits[:, :-1, :]
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - picked).mean()


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
