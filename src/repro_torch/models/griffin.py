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

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import shard
from .common import PSpec, rms_norm

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
    dtype = xr.dtype
    rgate = torch.sigmoid((xr @ p.w_a.to(dtype)).float())
    igate = torch.sigmoid((xr @ p.w_x.to(dtype)).float())
    log_a0 = F.logsigmoid(p.lam.float())                      # log a ∈ (−,0)
    log_a = RGLRU_C * rgate * log_a0[None, None, :]
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-9)) * igate * xr.float()
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` along axis 1 from ``h_{-1} = 0``, as a
    doubling (Hillis–Steele) scan of ``(a, b)`` pairs under
    ``(a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2)``: ⌈log2 S⌉ steps."""
    S = a.shape[1]
    off = 1
    while off < S:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        b = torch.cat([b[:, :off], a[:, off:] * b_prev + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a_prev], dim=1)
        off *= 2
    return b


def rglru_apply(p, x: torch.Tensor, cfg: ArchConfig,
                state: dict | None) -> tuple[torch.Tensor, dict]:
    dtype = x.dtype
    xi = rms_norm(x, p.norm)
    gate_br = F.gelu(xi @ p.w_gate_br.to(dtype), approximate="tanh")
    xr = xi @ p.w_in.to(dtype)
    buf = state["conv"] if state is not None else None
    xr, new_buf = _causal_conv(xr, p.conv_w.to(dtype), p.conv_b.to(dtype), buf)
    xr = shard(xr, "batch", "seq", "mlp")
    a, b = _gates(p, xr)
    if state is not None:                      # the state seeds step 0
        b = torch.cat([b[:, :1] + a[:, :1] * state["h"].float()[:, None],
                       b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    y = h.to(dtype) * gate_br
    out = y @ p.w_out.to(dtype)
    return x + out, {"h": h[:, -1, :], "conv": new_buf.float()}


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
