"""Griffin / RecurrentGemma blocks (arXiv:2402.19427; port of
``repro.models.griffin``): the RG-LRU recurrent block with its temporal
conv.

* Prefill/train runs the linear recurrence ``h_t = a_t h_{t-1} + b_t`` as a
  log-depth doubling scan over the sequence (the reference's
  ``lax.associative_scan``, which torch lacks).
* Decode carries ``(h, conv buffer)`` — constant-size state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import shard
from .common import PSpec, rms_norm, untracked

RGLRU_C = 8.0


def rglru_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    r = cfg.rnn_dim or d
    cw = cfg.conv_width
    return {
        "norm": PSpec((d,), (None,), "zeros"),
        "w_in": PSpec((d, r), ("embed_fsdp", "mlp")),       # recurrent branch
        "w_gate_br": PSpec((d, r), ("embed_fsdp", "mlp")),  # GeLU gate branch
        "conv_w": PSpec((cw, r), (None, "mlp"), scale=0.5),
        "conv_b": PSpec((r,), ("mlp",), "zeros"),
        "w_a": PSpec((r, r), (None, "mlp")),                # recurrence gate
        "w_x": PSpec((r, r), (None, "mlp")),                # input gate
        "lam": PSpec((r,), ("mlp",), "rglru_lambda"),
        "w_out": PSpec((r, d), ("mlp", "embed_fsdp")),
    }


def rglru_state_specs(cfg: ArchConfig, batch: int) -> dict:
    r = cfg.rnn_dim or cfg.d_model
    cw = cfg.conv_width
    return {"h": PSpec((batch, r), ("batch", "state"), "zeros",
                       dtype="float32"),
            "conv": PSpec((batch, cw - 1, r), ("batch", None, "state"),
                          "zeros", dtype="float32")}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 buf: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over seq via stacked shifts.  ``x [B, S, R]``,
    ``w [CW, R]``.  Returns (y, new buffer of the last CW−1 inputs)."""
    cw = w.shape[0]
    if buf is None:
        ctx = F.pad(x, (0, 0, cw - 1, 0))
    else:
        ctx = torch.cat([buf.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(cw):
        y = y + ctx[:, i:i + S, :] * w[cw - 1 - i][None, None, :]
    y = y + b[None, None, :]
    return y, ctx[:, -(cw - 1):, :]


def _gates(p, xr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence's ``(a, b)`` in float32.  Without autograd each
    ``[B, S, R]`` result is made once and updated in place (the same
    values, op for op: ``1 - a·a`` as ``-(a·a) + 1``)."""
    dtype = xr.dtype
    if not untracked(xr, p.w_a, p.w_x, p.lam):
        # the elementwise part checkpointed: its backward recomputes the
        # float32 gates from the two products instead of keeping them
        return checkpoint(_gate_math, xr @ p.w_a.to(dtype),
                          xr @ p.w_x.to(dtype), xr, p.lam,
                          use_reentrant=False, preserve_rng_state=False)
    log_a0 = F.logsigmoid(p.lam.float())                      # log a ∈ (−,0)
    a = (xr @ p.w_a.to(dtype)).float().sigmoid_()
    a.mul_(RGLRU_C).mul_(log_a0[None, None, :]).exp_()
    b = torch.mul(a, a).neg_().add_(1.0).clamp_min_(1e-9).sqrt_()
    b.mul_((xr @ p.w_x.to(dtype)).float().sigmoid_()).mul_(xr)
    return a, b


def _gate_math(ra, rx, xr, lam):
    """:func:`_gates` from its products ``xr @ w_a`` and ``xr @ w_x``."""
    rgate = torch.sigmoid(ra.float())
    igate = torch.sigmoid(rx.float())
    log_a0 = F.logsigmoid(lam.float())                        # log a ∈ (−,0)
    log_a = RGLRU_C * rgate * log_a0[None, None, :]
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-9)) * igate * xr.float()
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` along axis 1 from ``h_{-1} = 0``, as a
    doubling (Hillis–Steele) scan of ``(a, b)`` pairs under
    ``(a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2)``: ⌈log2 S⌉ steps.  Under
    autograd it is a :class:`_LinearScan`, whose backward is the same scan
    run backwards over the cotangents.  Without autograd the scan
    overwrites ``a`` and ``b`` (the result is ``b``): the caller gives
    them up."""
    if not untracked(a, b):
        return _LinearScan.apply(a, b)
    return _doubling_scan(a, b)


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The doubling scan on ``a`` and ``b``, overwriting both; returns
    ``b``.  Each step computes the shifted products into one temporary and
    adds them in place, so ``b``'s values are ``a·b_prev + b`` with the
    same two roundings as the out-of-place form."""
    S = a.shape[1]
    off = 1
    while off < S:
        b[:, off:].add_(a[:, off:] * b[:, :-off])
        if off * 2 < S:
            a[:, off:].mul_(a[:, :-off].clone())
        off *= 2
    return b


class _LinearScan(torch.autograd.Function):
    """:func:`linear_scan` with its own backward: for ``h = scan(a, b)``,
    the cotangent ``u`` of ``b`` is the scan backwards in time of
    ``(a_{t+1}, g_t)``, and that of ``a`` is ``u_t · h_{t-1}`` — the
    gradient of the recurrence itself, where autograd of the doubling
    scan would keep every step's ``[B, S, R]`` pair for its backward."""

    @staticmethod
    def forward(ctx, a, b):
        h = _doubling_scan(a.clone(), b.clone())
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        ar = torch.zeros_like(a)
        ar[:, 1:] = a[:, 1:].flip(1)            # a_{t+1}, reversed in time
        u = _doubling_scan(ar, g.flip(1)).flip(1)
        ga = torch.zeros_like(a)
        ga[:, 1:] = u[:, 1:] * h[:, :-1]
        return ga, u


def rglru_apply(p, x: torch.Tensor, cfg: ArchConfig,
                state: dict | None) -> tuple[torch.Tensor, dict]:
    dtype = x.dtype
    xi = rms_norm(x, p.norm)
    gate_br = F.gelu(xi @ p.w_gate_br.to(dtype), approximate="tanh")
    xr = xi @ p.w_in.to(dtype)
    del xi                      # each [B, S, .] temporary freed once used
    buf = state["conv"] if state is not None else None
    xr, new_buf = _causal_conv(xr, p.conv_w.to(dtype), p.conv_b.to(dtype), buf)
    # a copy: the view would keep the padded input alive
    new_buf = new_buf.to(torch.float32, copy=True)
    xr = shard(xr, "batch", "seq", "mlp")
    a, b = _gates(p, xr)
    del xr
    if state is not None:                      # the state seeds step 0
        b = torch.cat([b[:, :1] + a[:, :1] * state["h"].float()[:, None],
                       b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    del a, b
    y = h.to(dtype) * gate_br
    # the last step alone: a view would keep the whole scan alive
    h_last = h[:, -1, :].clone()
    del h, gate_br
    out = y @ p.w_out.to(dtype)
    return x + out, {"h": h_last, "conv": new_buf}


def rglru_decode(p, x: torch.Tensor, cfg: ArchConfig, state: dict
                 ) -> tuple[torch.Tensor, dict]:
    """``x [B, 1, D]`` one-step recurrence."""
    dtype = x.dtype
    xi = rms_norm(x, p.norm)
    gate_br = F.gelu(xi @ p.w_gate_br.to(dtype), approximate="tanh")
    xr = xi @ p.w_in.to(dtype)
    xr, new_buf = _causal_conv(xr, p.conv_w.to(dtype), p.conv_b.to(dtype),
                               state["conv"])
    a, b = _gates(p, xr)                           # [B, 1, R]
    h_new = a[:, 0] * state["h"].float() + b[:, 0]
    y = h_new[:, None, :].to(dtype) * gate_br
    out = y @ p.w_out.to(dtype)
    return x + out, {"h": h_new, "conv": new_buf.float()}
