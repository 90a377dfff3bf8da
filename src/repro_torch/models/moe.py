"""Mixture-of-Experts FFN with scatter-based capacity dispatch (port of
``repro.models.moe``).

Tokens are placed into per-expert capacity buffers with a cumsum-derived
position and a scatter-add, batched per batch row:

    x [B, S, D] → buffers [B, E, C, D] → expert SwiGLU (einsum over E) →
    gather back + combine weights.

Capacity ``C = max(ceil(S·top_k·cf / E), top_k)`` for the call's ``S`` (so
a decode step has ``C = max(ceil(top_k·cf / E), top_k)``); overflowing
tokens are dropped (Switch-style semantics) — their residual path still
carries them.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import local, shard
from .common import PSpec, swiglu


def moe_specs(cfg: ArchConfig) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, cfg.d_ff, m.n_experts
    specs = {
        "router": PSpec((d, e), (None, None)),
        "w_gate": PSpec((e, d, f), ("experts", "embed_fsdp", None)),
        "w_up": PSpec((e, d, f), ("experts", "embed_fsdp", None)),
        "w_down": PSpec((e, f, d), ("experts", None, "embed_fsdp")),
    }
    if m.shared_expert:
        specs.update({
            "sh_gate": PSpec((d, f), ("embed_fsdp", "mlp")),
            "sh_up": PSpec((d, f), ("embed_fsdp", "mlp")),
            "sh_down": PSpec((f, d), ("mlp", "embed_fsdp")),
        })
    return specs


def capacity(cfg: ArchConfig, seq: int) -> int:
    m = cfg.moe
    c = int(math.ceil(seq * m.top_k * m.capacity_factor / m.n_experts))
    return max(c, m.top_k)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: a stable descending sort, so the
    lower expert index comes first among equal weights."""
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], e[..., :k]


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """``x [B, S, D]`` → ``[B, S, D]``; ``p`` holds ``moe_specs``' tensors
    as attributes.  On a mesh the dispatch and the combine run on each
    device's batch rows (all experts' slots gathered for the combine) and
    the expert products on each device's experts."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    C = capacity(cfg, S)
    dtype = x.dtype

    logits = x @ p.router.to(dtype)
    b3, b4, b2 = ("batch", None, None), ("batch", None, None, None), \
        ("batch", None)
    buf, e_flat, pos_c, w_flat, keep = local(
        functools.partial(_dispatch, E=E, K=K, C=C), (b3, b3),
        (b4, b2, b2, b2, b2))(x, logits)
    buf = shard(buf, "batch", "experts", None, None)
    ex = ("experts", None, None)
    out_buf = local(_experts, (("batch", "experts", None, None), ex, ex, ex),
                    ("batch", "experts", None, None))(
        buf, p.w_gate.to(dtype), p.w_up.to(dtype), p.w_down.to(dtype))
    out_buf = shard(out_buf, "batch", "experts", None, None)
    y = local(functools.partial(_combine, S=S, K=K), (b4, b2, b2, b2, b2),
              b3)(out_buf, e_flat, pos_c, w_flat, keep)

    if m.shared_expert:
        y = y + swiglu(x, p.sh_gate.to(dtype), p.sh_up.to(dtype),
                       p.sh_down.to(dtype))
    return y


def _dispatch(x: torch.Tensor, logits: torch.Tensor, *, E: int, K: int,
              C: int):
    """Routing and the scatter into capacity buffers → ``(buf [B, E, C,
    D], e_flat, pos_c, w_flat, keep)``."""
    B, S, D = x.shape
    dtype = x.dtype
    probs = torch.softmax(logits.float(), dim=-1)
    top_w, top_e = top_k(probs, K)                            # [B, S, K]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    e_flat = top_e.reshape(B, S * K)                          # [B, T]
    w_flat = top_w.reshape(B, S * K).float()
    onehot = F.one_hot(e_flat, E)                             # [B, T, E]
    pos_all = torch.cumsum(onehot, dim=1) * onehot            # 1-based slot
    pos = pos_all.sum(-1) - 1                                 # [B, T]
    keep = (pos >= 0) & (pos < C)
    pos_c = pos.clamp(0, C - 1)

    x_rep = x.repeat_interleave(K, dim=1)                     # [B, T, D]
    x_rep = x_rep * keep[..., None].to(dtype)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    # A slot receives at most one kept token: dropped tokens clamp to slot
    # C-1 with zero rows.  So each sum is exact whatever order the adds
    # run in, and index_put_'s unordered accumulation on CUDA changes no bit.
    buf = torch.zeros((B, E, C, D), dtype=dtype, device=x.device)
    buf.index_put_((rows, e_flat, pos_c), x_rep, accumulate=True)
    return buf, e_flat, pos_c, w_flat, keep


def _experts(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU over its capacity slots."""
    g = torch.einsum("becd,edf->becf", buf, w_gate)
    u = torch.einsum("becd,edf->becf", buf, w_up)
    h = F.silu(g) * u
    return torch.einsum("becf,efd->becd", h, w_down)


def _combine(out_buf: torch.Tensor, e_flat: torch.Tensor,
             pos_c: torch.Tensor, w_flat: torch.Tensor, keep: torch.Tensor,
             *, S: int, K: int) -> torch.Tensor:
    """Gather each token's expert outputs back and mix them by weight."""
    B, D = out_buf.shape[0], out_buf.shape[-1]
    rows = torch.arange(B, device=out_buf.device)[:, None].expand(B, S * K)
    y = out_buf[rows, e_flat, pos_c]                          # [B, T, D]
    y = y * (w_flat * keep.float())[..., None].to(out_buf.dtype)
    return y.reshape(B, S, K, D).sum(dim=2)


def aux_load_balance_loss(logits: torch.Tensor, top_e: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E · Σ_e f_e · P_e (optional in training)."""
    probs = torch.softmax(logits.float(), -1)
    pe = probs.mean(dim=(0, 1))
    fe = F.one_hot(top_e[..., 0], n_experts).float().mean(dim=(0, 1))
    return n_experts * torch.sum(pe * fe)
