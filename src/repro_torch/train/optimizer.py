"""AdamW with dtype-configurable moments (port of ``repro.train.optimizer``).

Plain functions over the port's parameter tree, the layout a
:class:`~repro_torch.models.transformer.Transformer` is built from
(``repro_torch.models.weights.param_tree``: nested dicts of tensors, the
units as a list).  The update is the reference's ``upd``, operation for
operation and in its dtypes, not ``torch.optim.AdamW`` (the same update
in exact arithmetic, rounded differently): weight decay on every leaf,
norms and embeddings included, bias corrections ``1 - b ** step`` in
float32, the elementwise math in ``math_dtype`` and the moments stored in
``moment_dtype`` (bfloat16 for the 405B config).  It runs under
``torch.no_grad()`` and writes the parameters and moments in place.
:func:`abstract_state` is the state's shapes and dtypes as fake tensors,
for the dry run.

On a model placed on a ``DeviceMesh`` (``models.weights.place_model``)
the parameters, gradients and moments are DTensors of one placement each
leaf (a gradient that comes back in another is redistributed to its
parameter's), so the elementwise update runs on each rank's local shards
as it is; the global norm adds each rank's squares of the shards it
counts (``sharding.counted_here``) and all-reduces that sum once, so
every rank clips by the same scalar.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.distributed.sharding import counted_here, is_dtensor, like
from repro_torch.models.common import DTYPES, leaves, map_tree, zip_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    accum_dtype: str = "float32"   # grad-accumulation buffer (bf16 for 405B)
    math_dtype: str = "float32"    # optimizer elementwise math (bf16 slashes
                                   # the f32 temporary working set; used with
                                   # bf16 moments on memory-tight configs)
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # the reference maps the update over the leading (stacked-layers) axis
    # of big leaves so its f32 temporaries live one layer at a time; here
    # each unit is its own leaf already, so the update runs one layer at a
    # time either way and this field changes no arithmetic
    chunk_stacked: bool = False


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup → cosine decay, in float32 (a 0-d tensor on the
    step's device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments in ``moment_dtype`` beside each parameter (in its
    placement, for a DTensor), step 0."""
    mdt = DTYPES[cfg.moment_dtype]
    zeros = lambda p: torch.zeros_like(  # noqa: E731
        p, dtype=mdt, memory_format=torch.contiguous_format)
    device = leaves(params)[0].device
    return {"m": map_tree(zeros, params),
            "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_state(params_abs: Any, cfg: AdamWConfig) -> dict:
    """:func:`init`'s shapes and dtypes as fake tensors, beside the fake
    parameters ``params_abs`` (any layout) and on their device."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    mdt = DTYPES[cfg.moment_dtype]
    device = leaves(params_abs)[0].device
    with detect_fake_mode() or FakeTensorMode():
        z = lambda p: torch.empty(p.shape, dtype=mdt, device=device)  # noqa: E731
        return {"m": map_tree(z, params_abs), "v": map_tree(z, params_abs),
                "step": torch.empty((), dtype=torch.int32, device=device)}


def state_logical(params_logical: Any) -> dict:
    """Moments share the parameters' logical axes; step is replicated."""
    return {"m": params_logical, "v": params_logical, "step": ()}


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor itself."""
    return x.to_local() if is_dtensor(x) else x


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the float32 sum of each leaf's float32 sum of squares, the
    leaves in the port's order (the reference adds its stacked leaves, so
    the two differ by float32 rounding).  Of DTensor leaves each rank
    adds the shards it counts and one all-reduce sums the ranks, so every
    rank returns the same plain scalar."""
    xs = leaves(tree)
    sq = sum(torch.sum(torch.square(_local(x).to(torch.float32)))
             if counted_here(x) else
             torch.zeros((), device=_local(x).device) for x in xs)
    if any(is_dtensor(x) for x in xs):
        import torch.distributed as dist
        dist.all_reduce(sq)
    return torch.sqrt(sq)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    gn = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)
    return map_tree(lambda g: (_local(g).to(torch.float32) * scale
                               ).to(g.dtype), grads), gn


@torch.no_grad()
def apply(params: Any, grads: Any, state: dict, cfg: AdamWConfig
          ) -> tuple[Any, dict, dict]:
    """One AdamW step.  Writes ``params`` and the moments of ``state`` in
    place and returns ``(params, new_state, metrics)``; of DTensors, the
    local shards (the clipped gradients come back as local shards)."""
    grads, gnorm = clip_by_global_norm(zip_tree(like, grads, params),
                                       cfg.grad_clip)
    step = state["step"] + 1
    s = _local(step)
    lr = schedule(cfg, s)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** s.to(torch.float32)
    bc2 = 1 - b2 ** s.to(torch.float32)
    wdt = DTYPES[cfg.math_dtype]
    lr_w, bc1_w, bc2_w = lr.to(wdt), bc1.to(wdt), bc2.to(wdt)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        p, m, v = _local(p), _local(m), _local(v)
        gw = g.to(wdt)
        mw = b1 * m.to(wdt) + (1 - b1) * gw
        vw = b2 * v.to(wdt) + (1 - b2) * gw * gw
        mh = mw / bc1_w
        vh = vw / bc2_w
        delta = mh / (torch.sqrt(vh) + cfg.eps) + \
            (cfg.weight_decay * p.to(wdt)).to(wdt)
        p.copy_(p.to(wdt) - lr_w * delta)
        m.copy_(mw)
        v.copy_(vw)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
