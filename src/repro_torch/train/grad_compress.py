"""Gradient compression for bandwidth-bound data parallelism (port of
``repro.train.grad_compress``).

int8 block-quantized all-reduce with error feedback: each gradient leaf is
quantized (per 1024-element block absmax scaling) before the cross-replica
sum, and the quantization error is carried to the next step (error
feedback — keeps SGD/Adam convergence, cf. 1-bit Adam lineage).  4× fewer
bytes on the data-parallel gradient reduction.  The sums are
``torch.distributed.all_reduce`` over a process group; with no initialised
group the world is one process and both sums are the identity.

``quantize_int8`` / ``dequantize_int8`` are bitwise the reference's:
``torch.round`` rounds half to even as ``jnp.round`` does, and the block
scaling is one float32 division.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models.common import map_tree

BLOCK = 1024


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block absmax int8 quantization.  Returns (q int8, scales f32)."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp_min(scale, 1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: tuple[int, ...], dtype: torch.dtype
                    ) -> torch.Tensor:
    blocks = q.to(torch.float32) * scale[:, None]
    n = 1
    for s in shape:
        n *= s
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)


def _world(group) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(t, group=group)
    return t


def compressed_psum(grads: Any, group=None, error: Any | None = None
                    ) -> tuple[Any, Any]:
    """Quantize → all-reduce → dequantize with error feedback.

    ``error`` is the per-leaf carry from the previous step (or None), a
    tree of the grads' structure.  Returns (averaged grads, new error in
    bfloat16).  ``group`` is the data-parallel process group (``None``: the
    default group, or a world of one without one)."""
    n_dev = _world(group)

    def one(g, e):
        g32 = g.to(torch.float32)
        if e is not None:
            g32 = g32 + e.to(torch.float32)
        q, scale = quantize_int8(g32)
        deq_local = dequantize_int8(q, scale, tuple(g.shape), torch.float32)
        new_err = g32 - deq_local                       # error feedback
        q_sum = _all_reduce(q.to(torch.int32), group)
        s_sum = _all_reduce(scale.clone(), group)       # cheap approx: avg scale
        avg = q_sum.to(torch.float32) * (s_sum / n_dev)[:, None] / n_dev
        out = avg.reshape(-1)[:g32.numel()].reshape(g.shape).to(g.dtype)
        return out, new_err.to(torch.bfloat16)

    pairs = _map2(one, grads, error)            # (out, err) tuples: leaves
    return (map_tree(lambda pr: pr[0], pairs),
            map_tree(lambda pr: pr[1], pairs))


def _map2(fn, a, b):
    """``fn(leaf of a, leaf of b or None)`` over a tree of dicts and
    lists."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], None if b is None else b[k]) for k in a}
    if isinstance(a, list):
        return [_map2(fn, x, None if b is None else b[i])
                for i, x in enumerate(a)]
    return fn(a, b)
