"""xLSTM blocks (arXiv:2405.04517; port of ``repro.models.xlstm``) — mLSTM
(matrix memory, chunkwise-parallel) and sLSTM (scalar memory, sequential).

* mLSTM uses the chunkwise formulation: intra-chunk quadratic
  attention-like products plus an inter-chunk state recurrence, a loop
  over chunks of ``MLSTM_CHUNK`` steps.
* Gating is sigmoid-stabilized, as in the reference (the paper's exp-gates
  with a max-stabilizer are replaced by sigmoid input gates).
* sLSTM keeps its sequential recurrence, a loop over time of head-blocked
  products.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import shard
from .common import PSpec, rms_norm, scan

MLSTM_CHUNK = 256


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    inner = d                      # proj factor 1 → ≈6·D² params/block
    nh = cfg.n_heads
    return {
        "norm": PSpec((d,), (None,), "zeros"),
        "w_up": PSpec((d, 2 * inner), ("embed_fsdp", "mlp")),
        "wq": PSpec((inner, inner), ("embed_fsdp", "heads")),
        "wk": PSpec((inner, inner), ("embed_fsdp", "heads")),
        "wv": PSpec((inner, inner), ("embed_fsdp", "heads")),
        "w_if": PSpec((inner, 2 * nh), (None, None)),
        "out_norm": PSpec((inner,), (None,), "zeros"),
        "w_down": PSpec((inner, d), ("mlp", "embed_fsdp")),
    }


def mlstm_state_specs(cfg: ArchConfig, batch: int) -> dict:
    inner = cfg.d_model
    nh = cfg.n_heads
    dh = inner // nh
    return {
        "C": PSpec((batch, nh, dh, dh), ("batch", None, "state", None),
                   "zeros", dtype="float32"),
        "n": PSpec((batch, nh, dh), ("batch", None, "state"), "zeros",
                   dtype="float32"),
    }


def _mlstm_qkvif(p, x: torch.Tensor, cfg: ArchConfig, *,
                 scaled_q: bool = True):
    """The mLSTM's projections.  ``q`` comes as float32 divided by
    ``sqrt(dh)``, or, without ``scaled_q``, in the compute dtype for
    :func:`_mlstm_q` to scale a chunk at a time."""
    dtype = x.dtype
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    up = x @ p.w_up.to(dtype)
    xm, z = up.chunk(2, dim=-1)
    q = xm @ p.wq.to(dtype)
    k = xm @ p.wk.to(dtype)
    v = xm @ p.wv.to(dtype)
    gates = xm @ p.w_if.to(dtype)
    B, S = x.shape[:2]
    q = q.reshape(B, S, nh, dh)
    if scaled_q:
        q = _mlstm_q(q)
    k = k.reshape(B, S, nh, dh)
    v = v.reshape(B, S, nh, dh)
    i_g, f_g = gates.float().chunk(2, dim=-1)                 # [B, S, NH]
    return q, k, v, torch.sigmoid(i_g), torch.sigmoid(f_g) * 0.999 + 5e-4, z


def _mlstm_q(q: torch.Tensor) -> torch.Tensor:
    """``q [.., dh]`` as float32 over ``sqrt(dh)`` (the reference divides
    by a float64 scalar, which promotes to float32)."""
    return q.float() / math.sqrt(q.shape[-1])


def _mlstm_chunk(carry, xs, consts):
    """One chunk of :func:`mlstm_apply`'s loop: the carry ``(C, n)`` and
    the chunk's ``q, k, v [B, L, NH, dh]`` (made float32 here, ``q``
    scaled, a chunk at a time), ``i, f [B, L, NH]`` → the next carry and
    the chunk's ``h [B, L, NH, dh]``."""
    C, n = carry
    qb, kb, vb, ib, fb = xs
    qb, kb, vb = _mlstm_q(qb), kb.float(), vb.float()
    causal, ones = consts
    cl = torch.cumsum(torch.log(fb), dim=1)        # decay from chunk start
    dstart = torch.exp(cl)                         # Π_{s<=t} f_s
    # inter-chunk: h_t += (d_t · q_t)ᵀ C_prev
    h_inter = torch.einsum("blhd,bhde->blhe", qb * dstart[..., None], C)
    # intra-chunk: S[t,s] = exp(cl_t − cl_s) · i_s · (q_t·k_s), s ≤ t.
    # Mask the *exponent*: exp of the (discarded) upper triangle would
    # overflow and its inf·0 poisons the backward pass with NaNs.
    qk = torch.einsum("blhd,bmhd->bhlm", qb, kb)
    expo = cl[:, :, None, :] - cl[:, None, :, :]              # [B, L, M, NH]
    expo = torch.where(causal[None, :, :, None], expo, -30.0)
    gate = torch.exp(expo) * ib[:, None, :, :]
    gate = torch.where(causal[None, :, :, None], gate, 0.0)
    sc = qk * gate.permute(0, 3, 1, 2)
    h_intra = torch.einsum("bhlm,bmhd->blhd", sc, vb)
    n_inter = torch.einsum("blhd,bhd->blh", qb * dstart[..., None], n)
    n_intra = torch.einsum("bhlm,bmh->blh", sc, ones)         # Σ weights proxy
    denom = torch.clamp_min(torch.abs(n_inter + n_intra), 1.0)[..., None]
    h = (h_inter + h_intra) / denom
    # state to the next chunk
    dtail = torch.exp(cl[:, -1:, :] - cl)                     # Π_{s<t<=L}
    kw = kb * (dtail * ib)[..., None]
    decay = torch.exp(cl[:, -1, :])
    C = C * decay[:, :, None, None] + torch.einsum("blhd,blhe->bhde", kw, vb)
    n = n * decay[:, :, None] + kw.sum(dim=1)
    return (C, n), h


def mlstm_apply(p, x: torch.Tensor, cfg: ArchConfig,
                state: dict | None) -> tuple[torch.Tensor, dict]:
    """Sequence form (train/prefill).  Returns (y, final state)."""
    dtype = x.dtype
    B, S, D = x.shape
    nh = cfg.n_heads
    dh = D // nh
    h = rms_norm(x, p.norm)
    q, k, v, ig, fg, z = _mlstm_qkvif(p, h, cfg, scaled_q=False)
    del h                       # each [B, S, .] temporary freed once used

    L = min(MLSTM_CHUNK, S)
    assert S % L == 0, f"mLSTM chunk {L} must divide seq {S}"

    C = torch.zeros((B, nh, dh, dh), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, nh, dh), dtype=torch.float32, device=x.device)
    if state is not None:
        C = C + state["C"].float()
        n = n + state["n"].float()

    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    ones = torch.ones((B, L, nh), dtype=torch.float32, device=x.device)
    hs, (C, n) = scan("mlstm.chunks", _mlstm_chunk, L, (C, n),
                      (q, k, v, ig, fg), (causal, ones), (B, S, nh, dh),
                      torch.float32)
    del q, k, v, ig, fg
    hs = hs.reshape(B, S, D).to(dtype)
    hs = rms_norm(hs, p.out_norm)
    y = hs * F.silu(z)
    y = shard(y, "batch", "seq", None)
    out = y @ p.w_down.to(dtype)
    return x + out, {"C": C, "n": n}


def mlstm_decode(p, x: torch.Tensor, cfg: ArchConfig, state: dict
                 ) -> tuple[torch.Tensor, dict]:
    """One-token recurrent step.  ``x [B, 1, D]``."""
    dtype = x.dtype
    B, _, D = x.shape
    h = rms_norm(x, p.norm)
    q, k, v, ig, fg, z = _mlstm_qkvif(p, h, cfg)
    q, k, v = (t[:, 0].float() for t in (q, k, v))           # [B, NH, dh]
    ig, fg = ig[:, 0], fg[:, 0]                               # [B, NH]
    C = state["C"].float()
    n = state["n"].float()
    C_new = fg[..., None, None] * C + ig[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", k, v)
    n_new = fg[..., None] * n + ig[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    den = torch.clamp_min(torch.abs(torch.einsum("bhd,bhd->bh", q, n_new)), 1.0)
    hout = (num / den[..., None]).reshape(B, 1, D).to(dtype)
    hout = rms_norm(hout, p.out_norm)
    y = hout * F.silu(z)
    out = y @ p.w_down.to(dtype)
    return x + out, {"C": C_new, "n": n_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    return {
        "norm": PSpec((d,), (None,), "zeros"),
        "w_g": PSpec((d, 4 * d), ("embed_fsdp", "mlp")),
        "r_g": PSpec((nh, dh, 4 * dh), (None, None, None),
                     scale=1.0 / math.sqrt(dh)),
        "out_norm": PSpec((d,), (None,), "zeros"),
        "w_down": PSpec((d, d), ("mlp", "embed_fsdp")),
    }


def slstm_state_specs(cfg: ArchConfig, batch: int) -> dict:
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    sl = ("batch", None, "state")
    return {"h": PSpec((batch, nh, dh), sl, "zeros", dtype="float32"),
            "c": PSpec((batch, nh, dh), sl, "zeros", dtype="float32"),
            "n": PSpec((batch, nh, dh), sl, "zeros", dtype="float32")}


def _slstm_cell(gx, h, c, n, r_g):
    """One recurrence step.  gx [B, NH, 4dh] (input contribution)."""
    gr = torch.einsum("bhd,hdg->bhg", h, r_g)
    gi, gf, gz, go = (gx + gr).chunk(4, dim=-1)
    i = torch.sigmoid(gi)
    f = torch.sigmoid(gf)
    zt = torch.tanh(gz)
    o = torch.sigmoid(go)
    c_new = f * c + i * zt
    n_new = f * n + i
    h_new = o * c_new / torch.clamp_min(n_new, 1.0)
    return h_new, c_new, n_new


def _slstm_step(carry, xs, consts):
    """One step of :func:`slstm_apply`'s loop: ``(h, c, n)`` and the step's
    ``gx [B, 1, NH, 4dh]`` (as float32 here, a step at a time) → the next
    carry and ``h [B, 1, NH, dh]``."""
    h, c, n = _slstm_cell(xs[0][:, 0].float(), *carry, consts[0])
    return (h, c, n), h[:, None]


def slstm_apply(p, x: torch.Tensor, cfg: ArchConfig,
                state: dict | None) -> tuple[torch.Tensor, dict]:
    dtype = x.dtype
    B, S, D = x.shape
    nh = cfg.n_heads
    dh = D // nh
    xi = rms_norm(x, p.norm)
    gx = (xi @ p.w_g.to(dtype)).reshape(B, S, nh, 4 * dh)
    del xi
    r_g = p.r_g.float()
    if state is not None:
        h, c, n = (state[key].float() for key in ("h", "c", "n"))
    else:
        h = torch.zeros((B, nh, dh), dtype=torch.float32, device=x.device)
        c, n = torch.zeros_like(h), torch.zeros_like(h)
    hs, (h, c, n) = scan("slstm.steps", _slstm_step, 1, (h, c, n), (gx,),
                         (r_g,), (B, S, nh, dh), torch.float32)
    del gx
    hs = hs.reshape(B, S, D).to(dtype)
    hs = rms_norm(hs, p.out_norm)
    out = hs @ p.w_down.to(dtype)
    return x + out, {"h": h, "c": c, "n": n}


def slstm_decode(p, x: torch.Tensor, cfg: ArchConfig, state: dict
                 ) -> tuple[torch.Tensor, dict]:
    return slstm_apply(p, x, cfg, state)
