"""Carrying the reference's parameters and caches across.

``jax.random`` streams cannot be reproduced in torch, so the tests hold
the port against the reference on the reference's own parameters: its
tree, given as numpy arrays, becomes the port's model here.  The stacked
``[n_units, ...]`` leaves are sliced into the units of the model's
``ModuleList`` (and the encoder's ``[encoder_layers, ...]`` leaves into its
layers).  Caches and the AdamW state go both ways, so a prefill cache of
one package feeds the other's decode, one optimizer's state the other's
step, and caches and states compare leaf by leaf.

:func:`place_model` places a model on the ranks of a ``DeviceMesh``: each
parameter becomes a DTensor of the reference's placement for it
(:func:`logical_names` under the active ``logical_rules``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device_index import resolve_device
from .common import logical_tree, map_tree, zip_tree
from .transformer import Transformer, init_specs


def _split(tree: Any, n: int) -> list:
    """A tree of stacked leaves → ``n`` trees of their slices."""
    return [map_tree(lambda a: a[i], tree) for i in range(n)]


def _stack(trees: list) -> Any:
    """``n`` trees of equal structure → one tree of stacked numpy leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack([_np(t) for t in trees])


def _np(t) -> np.ndarray:
    """A tensor as numpy (bfloat16, which numpy lacks, as float32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16 from JAX
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_reference(cfg: ArchConfig, tree: dict,
                          device: str | torch.device = "cuda") -> dict:
    """The reference's parameter tree (numpy leaves) in the port's layout,
    as tensors on ``device``."""
    device = resolve_device(device)
    t = map_tree(lambda a: _tensor(a, device), tree)
    out = {k: v for k, v in t.items() if k not in ("stack", "encoder")}
    out["units"] = _split(t["stack"], cfg.n_units)
    if "encoder" in t:
        out["encoder"] = {"layers": _split(t["encoder"]["stack"],
                                           cfg.encoder_layers),
                          "final_norm": t["encoder"]["final_norm"]}
    return out


def model_from_reference(cfg: ArchConfig, tree: dict,
                         device: str | torch.device = "cuda") -> Transformer:
    """The port's model holding the reference's parameters."""
    return Transformer(cfg, params_from_reference(cfg, tree, device))


def param_tree(model: Transformer, grads: bool = False) -> dict:
    """The model's parameters in the port's layout, the one
    :class:`Transformer` is built from: ``{"embed", "lm_head",
    "final_norm"?, "units": [unit tree, ...], "rem"?, "encoder":
    {"layers": [...], "final_norm"}?}``.  The leaves are the parameters
    themselves (the optimizer writes them in place); with ``grads``, their
    gradients, zeros where a parameter has none."""
    def tree(mod) -> dict:
        out = {}
        for name, p in mod.named_parameters(recurse=False):
            if grads:
                p = p.grad if p.grad is not None else torch.zeros_like(p)
            out[name] = p
        for name, child in mod.named_children():
            out[name] = tree(child)
        return out
    t = tree(model)
    t["units"] = [t["units"][str(i)] for i in range(len(model.units))]
    if not t.get("rem"):
        t.pop("rem", None)
    if "encoder" in t:
        layers = t["encoder"]["layers"]
        t["encoder"]["layers"] = [layers[str(i)] for i in range(len(layers))]
    return t


def tree_to_reference(tree: dict) -> dict:
    """A tree in the port's parameter layout (parameters, gradients or an
    AdamW moment) as the reference's stacked tree of numpy arrays."""
    out = map_tree(_np, {k: v for k, v in tree.items()
                         if k not in ("units", "encoder")})
    out["stack"] = _stack(tree["units"])
    if "encoder" in tree:
        out["encoder"] = {"stack": _stack(tree["encoder"]["layers"]),
                          "final_norm": _np(tree["encoder"]["final_norm"])}
    return out


def params_to_reference(model: Transformer, grads: bool = False) -> dict:
    """The model's parameters (or, with ``grads``, their gradients) as the
    reference's stacked tree of numpy arrays."""
    return tree_to_reference(param_tree(model, grads))


def opt_state_from_reference(cfg: ArchConfig, state: dict,
                             device: str | torch.device = "cuda") -> dict:
    """The reference's AdamW state (``m``, ``v`` in its parameter layout,
    ``step``; numpy leaves) as the port's ``train.optimizer`` state on
    ``device``."""
    device = resolve_device(device)
    return {"m": params_from_reference(cfg, state["m"], device),
            "v": params_from_reference(cfg, state["v"], device),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


def opt_state_to_reference(state: dict) -> dict:
    """The port's AdamW state as the reference's tree of numpy arrays
    (bfloat16 moments as float32, which holds them exactly)."""
    return {"m": tree_to_reference(state["m"]),
            "v": tree_to_reference(state["v"]),
            "step": np.asarray(int(state["step"]), np.int32)}


def cache_from_reference(cfg: ArchConfig, tree: dict,
                         device: str | torch.device = "cuda") -> dict:
    """The reference's cache tree (numpy leaves; ``stack`` stacked
    ``[n_units, ...]``) as the port's caches on ``device``."""
    device = resolve_device(device)
    t = map_tree(lambda a: _tensor(a, device), tree)
    out = {"units": _split(t["stack"], cfg.n_units)}
    if "rem" in t:
        out["rem"] = t["rem"]
    return out


def cache_to_reference(caches: dict) -> dict:
    """The port's caches as the reference's tree of numpy arrays."""
    out = {"stack": _stack(caches["units"])}
    if "rem" in caches:
        out["rem"] = map_tree(_np, caches["rem"])
    return out


def logical_names(cfg: ArchConfig) -> dict:
    """The logical axis names of each parameter in the port's layout: the
    reference's ``logical_tree(init_specs(cfg))`` with each unit (and
    encoder layer) named as its stacked leaf less the leading ``layers``
    axis.  AdamW's moments share them (``optimizer.state_logical``)."""
    t = logical_tree(init_specs(cfg))
    unit = lambda tree: map_tree(lambda names: names[1:], tree)  # noqa: E731
    out = {k: v for k, v in t.items() if k not in ("stack", "encoder")}
    out["units"] = [unit(t["stack"])] * cfg.n_units
    if "encoder" in t:
        out["encoder"] = {"layers": [unit(t["encoder"]["stack"])]
                          * cfg.encoder_layers,
                          "final_norm": t["encoder"]["final_norm"]}
    return out


def place_model(model: Transformer) -> Transformer:
    """A model of ``model``'s values placed on the active ``DeviceMesh``
    under the active rules (``sharding.logical_rules``): each parameter
    a DTensor of its :func:`logical_names`' placements (``shardings_for``),
    this rank's shard kept from the whole tensor, which every rank must
    hold (the same generator seed on each): no collective.  Each unit's
    parameter is a leaf of its own, with its own gradient."""
    from repro_torch.distributed.sharding import (get_device_mesh, place,
                                                  shardings_for)
    mesh = get_device_mesh()
    if mesh is None:
        raise ValueError("place_model needs logical_rules over a DeviceMesh")
    tree = param_tree(model)
    pl = shardings_for(tree, logical_names(model.cfg))
    placed = zip_tree(lambda p, q: place(p.detach(), q, mesh), tree, pl)
    return Transformer(model.cfg, placed)

