"""Unified model stack for the assigned architectures (port of
``repro.models.transformer``).

One implementation drives all 10 configs through a block-pattern
abstraction: the pattern (e.g. ``('rglru','rglru','lattn')``) is one
*unit*.  A :class:`Transformer` holds a ``ModuleList`` of units (each a
``ModuleDict`` of one module per block, ``b0, b1, …``) and a Python loop
over them stands for the reference's ``lax.scan`` over parameters stacked
``[n_units, ...]``.  Remainder blocks (pattern not dividing n_layers) run
after the units.  Each block kind is a module whose ``forward`` is that
kind's branch of the reference's ``block_apply``.

Modes:
  * ``train``   — full causal forward → logits [B, S, V]
  * ``prefill`` — forward + per-layer caches/states, logits at last pos
  * ``decode``  — one token against caches/states

Caches are ``{"units": [per-unit dict, ...], "rem": {...}}``; attention
caches are ``[B, S_cache, KV, Dh]`` tensors, recurrent blocks carry
constant-size states.  Parameters stay in ``param_dtype`` and every use
casts them to ``compute_dtype``, as the reference does.

Entry points run on ``"cuda"`` unless the caller passes the CPU, and
raise where CUDA is absent.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device_index import resolve_device
from repro_torch.distributed.sharding import (batch_local, divisible,
                                              is_dtensor, like, local, shard,
                                              write_slot)
from . import griffin, moe as moe_mod, xlstm
from .common import (DTYPES, PSpec, abstract, attention, decode_attention,
                     default_scale, gelu_mlp, init_one, init_params as
                     init_tree, layer_norm_nonparam, leaves,
                     map_tree, norm, rms_norm, rope, sinusoidal,
                     sinusoidal_at, swiglu, work_dtype)


# ---------------------------------------------------------------------------
# parameter specs (the reference's tree: unit leaves stacked [n_units, ...])
# ---------------------------------------------------------------------------

def _norm_spec(cfg: ArchConfig) -> PSpec | None:
    return None if cfg.nonparam_norm else PSpec((cfg.d_model,), (None,),
                                                "zeros")


def _maybe(d: dict, key: str, spec: PSpec | None) -> None:
    if spec is not None:
        d[key] = spec


def attn_specs(cfg: ArchConfig, *, cross: bool = False) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    q, kv = cfg.q_dim, cfg.kv_dim
    s: dict = {}
    _maybe(s, "norm", _norm_spec(cfg))
    s["wq"] = PSpec((d, q), ("embed_fsdp", "heads"))
    s["wk"] = PSpec((d, kv), ("embed_fsdp", "kv"))
    s["wv"] = PSpec((d, kv), ("embed_fsdp", "kv"))
    s["wo"] = PSpec((q, d), ("heads", "embed_fsdp"))
    if cfg.qk_norm and not cross:
        s["qn"] = PSpec((hd,), (None,), "zeros")
        s["kn"] = PSpec((hd,), (None,), "zeros")
    return s


def ffn_specs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    s: dict = {}
    _maybe(s, "norm", _norm_spec(cfg))
    if cfg.family == "encdec":                      # whisper: GELU MLP
        s["w_up"] = PSpec((d, f), ("embed_fsdp", "mlp"))
        s["w_down"] = PSpec((f, d), ("mlp", "embed_fsdp"))
    else:
        s["w_gate"] = PSpec((d, f), ("embed_fsdp", "mlp"))
        s["w_up"] = PSpec((d, f), ("embed_fsdp", "mlp"))
        s["w_down"] = PSpec((f, d), ("mlp", "embed_fsdp"))
    return s


def block_specs(cfg: ArchConfig, kind: str) -> dict:
    if kind in ("attn", "lattn"):
        return {"attn": attn_specs(cfg), "ffn": ffn_specs(cfg)}
    if kind == "dattn":                              # enc-dec decoder layer
        return {"attn": attn_specs(cfg), "xattn": attn_specs(cfg, cross=True),
                "ffn": ffn_specs(cfg)}
    if kind == "xattn":                              # VLM cross-attn layer
        s = {"attn": attn_specs(cfg, cross=True), "ffn": ffn_specs(cfg)}
        s["gate"] = PSpec((1,), (None,), "zeros")    # gated residual
        return s
    if kind == "moe":
        return {"attn": attn_specs(cfg), "moe": moe_mod.moe_specs(cfg),
                "moe_norm": _norm_spec(cfg) or PSpec((cfg.d_model,), (None,),
                                                     "zeros")}
    if kind == "rglru":
        return {"rec": griffin.rglru_specs(cfg), "ffn": ffn_specs(cfg)}
    if kind == "mlstm":
        return {"cell": xlstm.mlstm_specs(cfg)}
    if kind == "slstm":
        return {"cell": xlstm.slstm_specs(cfg)}
    raise ValueError(kind)


def effective_pattern(cfg: ArchConfig) -> tuple[str, ...]:
    if cfg.family == "encdec":
        return tuple("dattn" for _ in cfg.block_pattern)
    return cfg.block_pattern


def _rem_kinds(cfg: ArchConfig) -> list[str]:
    return ["dattn" if cfg.family == "encdec" else k
            for k in cfg.remainder_pattern]


def _stack_spec(s: PSpec, n: int) -> PSpec:
    """The reference's stacking of a unit leaf: a leading ``n`` (which then
    sets the default stddev) and no per-leaf dtype."""
    return PSpec((n,) + s.shape, ("layers",) + s.logical, s.init, s.scale)


def init_specs(cfg: ArchConfig) -> dict:
    """Full parameter spec tree, in the reference's stacked layout."""
    unit = {f"b{i}": block_specs(cfg, k)
            for i, k in enumerate(effective_pattern(cfg))}
    specs: dict = {
        "embed": PSpec((cfg.vocab, cfg.d_model), ("vocab", "embed_fsdp"),
                       scale=0.02),
        "stack": map_tree(lambda s: _stack_spec(s, cfg.n_units), unit),
        "lm_head": PSpec((cfg.d_model, cfg.vocab), ("embed_fsdp", "vocab")),
    }
    _maybe(specs, "final_norm", _norm_spec(cfg))
    if cfg.remainder_pattern:
        specs["rem"] = {f"r{i}": block_specs(cfg, k)
                        for i, k in enumerate(_rem_kinds(cfg))}
    if cfg.family == "encdec":
        enc_unit = {"attn": attn_specs(cfg), "ffn": ffn_specs(cfg)}
        specs["encoder"] = {
            "stack": map_tree(lambda s: _stack_spec(s, cfg.encoder_layers),
                              enc_unit),
            "final_norm": PSpec((cfg.d_model,), (None,), "zeros"),
        }
    return specs


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

def _attn_cache(cfg: ArchConfig, batch: int, seq: int, *,
                window: int = 0) -> dict:
    s_c = min(window, seq) if window else seq
    kl = ("batch", "cache_seq", "kv", None)
    shape = (batch, s_c, cfg.n_kv_heads, cfg.head_dim)
    return {"k": PSpec(shape, kl, "zeros"), "v": PSpec(shape, kl, "zeros")}


def _xattn_cache(cfg: ArchConfig, batch: int) -> dict:
    src = cfg.encoder_seq if cfg.family == "encdec" else cfg.vision_tokens
    kl = ("batch", "cache_seq", "kv", None)
    shape = (batch, src, cfg.n_kv_heads, cfg.head_dim)
    return {"xk": PSpec(shape, kl, "zeros"), "xv": PSpec(shape, kl, "zeros")}


def block_cache_specs(cfg: ArchConfig, kind: str, batch: int,
                      seq: int) -> dict:
    if kind in ("attn", "moe"):
        return _attn_cache(cfg, batch, seq)
    if kind == "lattn":
        return _attn_cache(cfg, batch, seq, window=cfg.window)
    if kind == "dattn":
        return {**_attn_cache(cfg, batch, seq), **_xattn_cache(cfg, batch)}
    if kind == "xattn":
        return _xattn_cache(cfg, batch)
    if kind == "rglru":
        return griffin.rglru_state_specs(cfg, batch)
    if kind == "mlstm":
        return xlstm.mlstm_state_specs(cfg, batch)
    if kind == "slstm":
        return xlstm.slstm_state_specs(cfg, batch)
    raise ValueError(kind)


def cache_specs(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """Cache spec tree, in the reference's stacked layout."""
    unit = {f"b{i}": block_cache_specs(cfg, k, batch, seq)
            for i, k in enumerate(effective_pattern(cfg))}
    out = {"stack": map_tree(lambda s: _stack_spec(s, cfg.n_units), unit)}
    if cfg.remainder_pattern:
        out["rem"] = {f"r{i}": block_cache_specs(cfg, k, batch, seq)
                      for i, k in enumerate(_rem_kinds(cfg))}
    return out


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Params(nn.Module):
    """A subtree of parameters under the reference's names: tensors become
    parameters, dicts child ``Params``.  An absent optional leaf (``norm``
    under a non-parametric norm) reads as ``None`` through ``getattr``."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, Params(val))
            else:
                self.register_parameter(key, nn.Parameter(val))


@dataclasses.dataclass
class Ctx:
    cfg: ArchConfig
    mode: str                       # 'train' | 'prefill' | 'decode'
    pos: int | None = None          # decode position
    enc: Any = None                 # encoder output / vision patches


def _project_qkv(p: Params, xq: torch.Tensor, xkv: torch.Tensor,
                 cfg: ArchConfig):
    dtype = xq.dtype
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    wk, wv = p.wk.to(dtype), p.wv.to(dtype)
    # on a mesh each device projects its own heads where the model axis
    # divides the head count (kv heads too, as the reference's compiler
    # does; the weights stay placed as stored), else every head
    hq, hkv = _heads(cfg.n_heads), _heads(cfg.n_kv_heads)
    if hkv is not None:
        wk, wv = shard(wk, "embed", "heads"), shard(wv, "embed", "heads")
    q = shard(xq @ p.wq.to(dtype), "batch", "seq", hq).reshape(
        B, Sq, cfg.n_heads, cfg.head_dim)
    k = shard(xkv @ wk, "batch", "seq", hkv).reshape(
        B, Skv, cfg.n_kv_heads, cfg.head_dim)
    v = shard(xkv @ wv, "batch", "seq", hkv).reshape(
        B, Skv, cfg.n_kv_heads, cfg.head_dim)
    if getattr(p, "qn", None) is not None:
        q = rms_norm(q, p.qn)
        k = rms_norm(k, p.kn)
    return q, k, v


def _heads(n: int) -> str | None:
    """``"heads"`` where the mesh's model axis divides ``n`` heads (always
    without a mesh), else ``None``: a flat ``heads × head_dim`` dimension
    is sharded only where whole heads land on each device."""
    return "heads" if divisible(n, ("heads",), 0) else None


def _replicated(h: torch.Tensor) -> torch.Tensor:
    """A normed activation entering a block's products: on a mesh it is
    batch-sharded and whole along the sequence and features (the
    reference's compiler places it so from the products' own shardings),
    so the products shard by heads and by the FFN width; ``h`` itself
    without one."""
    return shard(h, "batch", "seq", None)


def _write(buf: torch.Tensor, new: torch.Tensor, at: int) -> torch.Tensor:
    """``dynamic_update_slice`` of one position along axis 1, in place; the
    start clamps into range as XLA clamps it."""
    at = min(max(at, 0), buf.shape[1] - 1)
    return write_slot(buf, new, at)


def _self_attention(p: Params, x: torch.Tensor, ctx: Ctx, cache: dict | None,
                    *, causal: bool, window: int = 0
                    ) -> tuple[torch.Tensor, dict | None]:
    cfg = ctx.cfg
    dtype = x.dtype
    h = _replicated(norm(x, getattr(p, "norm", None), cfg.nonparam_norm))
    q, k, v = _project_qkv(p, h, h, cfg)
    new_cache = None
    if ctx.mode == "decode":
        pos = ctx.pos
        if cfg.rope_theta:
            pvec = torch.full((1,), pos, device=x.device)
            q = rope(q, pvec, cfg.rope_theta)
            k = rope(k, pvec, cfg.rope_theta)
        if window:
            slot = pos % window                    # ring buffer
            kc = _write(cache["k"], k, slot)
            vc = _write(cache["v"], v, slot)
            W = kc.shape[1]
            valid_upto = W if pos >= W else pos + 1
            out = decode_attention(q, kc, vc, valid_upto - 1)
        else:
            kc = _write(cache["k"], k, pos)
            vc = _write(cache["v"], v, pos)
            out = decode_attention(q, kc, vc, pos)
        new_cache = {"k": kc, "v": vc}
    else:
        if cfg.rope_theta:
            pvec = torch.arange(x.shape[1], device=x.device)
            q = rope(q, pvec, cfg.rope_theta)
            k = rope(k, pvec, cfg.rope_theta)
        out = attention(q, k, v, causal=causal, window=window,
                        chunk=cfg.attn_chunk)
        if ctx.mode == "prefill":
            if window and x.shape[1] > window:
                # ring-buffer alignment: position p lives at slot p % window;
                # on a mesh on each device's shard (the sequence is whole
                # there; DTensor has no sharding strategy for roll in every
                # torch version)
                shift = x.shape[1] % window
                names = ("batch", None, _heads(cfg.n_kv_heads), None)
                ring = local(lambda t: torch.roll(t[:, -window:], shift, 1),
                             (names,), names)
                new_cache = {"k": ring(k).to(dtype), "v": ring(v).to(dtype)}
            else:
                new_cache = {"k": k.to(dtype), "v": v.to(dtype)}
            new_cache = _cache_placed(new_cache, cfg)
    out = shard(out, "batch", "seq", "heads", None)
    B, Sq = out.shape[:2]
    o = shard(out.reshape(B, Sq, cfg.q_dim), "batch", "seq",
              _heads(cfg.n_heads)) @ p.wo.to(dtype)
    return x + like(o, x), new_cache


def _cache_placed(cache: dict, cfg: ArchConfig) -> dict:
    """A prefill's attention cache.  Where the mesh's model axis does not
    divide the kv heads (so each device projected them all), placed as the
    decode step reads it (``_attn_cache``'s names: the sequence over the
    model axis), so each device keeps its slice and not a replica; as it
    is otherwise, and without a mesh."""
    if _heads(cfg.n_kv_heads) is not None:
        return cache
    return {key: shard(t, "batch", "cache_seq", "kv", None)
            for key, t in cache.items()}


def _cross_attention(p: Params, x: torch.Tensor, ctx: Ctx, cache: dict | None
                     ) -> tuple[torch.Tensor, dict | None]:
    """Cross-attn to encoder frames / vision patches: k/v from ``ctx.enc``
    (prefill/train) or from the cache (decode, over the whole source)."""
    cfg = ctx.cfg
    dtype = x.dtype
    h = _replicated(norm(x, getattr(p, "norm", None), cfg.nonparam_norm))
    new_cache = None
    if ctx.mode == "decode":
        B, Sq, _ = h.shape
        q = shard(h @ p.wq.to(dtype), "batch", "seq",
                  _heads(cfg.n_heads)).reshape(
            B, Sq, cfg.n_heads, cfg.head_dim)
        k, v = cache["xk"], cache["xv"]
        out = decode_attention(q, k, v, k.shape[1] - 1)
        new_cache = {"xk": k, "xv": v}
    else:
        q, k, v = _project_qkv(p, h, ctx.enc.to(dtype), cfg)
        out = attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
        if ctx.mode == "prefill":
            new_cache = _cache_placed({"xk": k.to(dtype), "xv": v.to(dtype)},
                                      cfg)
    B, Sq = out.shape[:2]
    o = shard(out.reshape(B, Sq, cfg.q_dim), "batch", "seq",
              _heads(cfg.n_heads)) @ p.wo.to(dtype)
    return x + like(o, x), new_cache


def _ffn(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dtype = x.dtype
    h = _replicated(norm(x, getattr(p, "norm", None), cfg.nonparam_norm))
    if cfg.family == "encdec":
        return x + like(gelu_mlp(h, p.w_up.to(dtype), p.w_down.to(dtype)),
                        x)
    return x + like(swiglu(h, p.w_gate.to(dtype), p.w_up.to(dtype),
                           p.w_down.to(dtype)), x)


def _residual_shard(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """Sequence-parallel residual stream (train only)."""
    if ctx.mode == "train" and ctx.cfg.act_shard == "seq":
        return shard(x, "batch", "act_seq", None)
    return x


class AttnBlock(Params):
    """Full-attention transformer block."""

    def forward(self, x, ctx: Ctx, cache):
        x = _residual_shard(x, ctx)
        x, c1 = _self_attention(self.attn, x, ctx, cache, causal=True)
        x = _residual_shard(x, ctx)
        return _ffn(self.ffn, x, ctx.cfg), c1


class MoEBlock(Params):
    """Attention then a MoE FFN."""

    def forward(self, x, ctx: Ctx, cache):
        cfg = ctx.cfg
        x = _residual_shard(x, ctx)
        x, c1 = _self_attention(self.attn, x, ctx, cache, causal=True)
        x = _residual_shard(x, ctx)
        h = _replicated(norm(x, getattr(self, "moe_norm", None),
                             cfg.nonparam_norm))
        return x + like(moe_mod.moe_apply(self.moe, h, cfg), x), c1


class LAttnBlock(Params):
    """Local (sliding-window) attention block; its decode cache is a ring
    buffer of ``window`` slots."""

    def forward(self, x, ctx: Ctx, cache):
        x = _residual_shard(x, ctx)
        x, c1 = _self_attention(self.attn, x, ctx, cache, causal=True,
                                window=ctx.cfg.window)
        return _ffn(self.ffn, x, ctx.cfg), c1


class DAttnBlock(Params):
    """Encoder-decoder decoder layer: causal self-attention, cross-attention
    to the encoder's frames, FFN."""

    def forward(self, x, ctx: Ctx, cache):
        x = _residual_shard(x, ctx)
        self_cache = None if cache is None else {k: cache[k] for k in ("k", "v")}
        x, c1 = _self_attention(self.attn, x, ctx, self_cache, causal=True)
        xc = None if cache is None else {k: cache[k] for k in ("xk", "xv")}
        x, c2 = _cross_attention(self.xattn, x, ctx, xc)
        x = _ffn(self.ffn, x, ctx.cfg)
        if c1 is None and c2 is None:
            return x, None
        return x, {**(c1 or {}), **(c2 or {})}


class XAttnBlock(Params):
    """VLM cross-attention layer with a gated residual."""

    def forward(self, x, ctx: Ctx, cache):
        x = _residual_shard(x, ctx)
        y, c1 = _cross_attention(self.attn, x, ctx, cache)
        gate = torch.tanh(self.gate.to(x.dtype))
        x = x + gate * (y - x)           # y already holds x: kept literally
        return _ffn(self.ffn, x, ctx.cfg), c1


def _recurrent(fn, p: Params, x: torch.Tensor, ctx: Ctx, cache):
    """A recurrent cell ``fn(p, x, cfg, state)``; on a mesh, on each
    device's batch rows with the cell's weights whole (DTensor has no
    sharding strategy for its scans and gates)."""
    out = batch_local(lambda b, w: fn(w, b[0], ctx.cfg, b[1]), (x, cache), p)
    return out[0], out[1]


class RGLRUBlock(Params):
    """Griffin recurrent block then an FFN."""

    def forward(self, x, ctx: Ctx, cache):
        x = _residual_shard(x, ctx)
        fn = griffin.rglru_decode if ctx.mode == "decode" else griffin.rglru_apply
        x, st = _recurrent(fn, self.rec, x, ctx, cache)
        return _ffn(self.ffn, x, ctx.cfg), st


class MLSTMBlock(Params):
    def forward(self, x, ctx: Ctx, cache):
        x = _residual_shard(x, ctx)
        fn = xlstm.mlstm_decode if ctx.mode == "decode" else xlstm.mlstm_apply
        return _recurrent(fn, self.cell, x, ctx, cache)


class SLSTMBlock(Params):
    def forward(self, x, ctx: Ctx, cache):
        x = _residual_shard(x, ctx)
        fn = xlstm.slstm_decode if ctx.mode == "decode" else xlstm.slstm_apply
        return _recurrent(fn, self.cell, x, ctx, cache)


BLOCKS = {"attn": AttnBlock, "moe": MoEBlock, "lattn": LAttnBlock,
          "dattn": DAttnBlock, "xattn": XAttnBlock, "rglru": RGLRUBlock,
          "mlstm": MLSTMBlock, "slstm": SLSTMBlock}


class Encoder(nn.Module):
    """Whisper encoder over precomputed frame embeddings (frontend stub)."""

    def __init__(self, tree: dict):
        super().__init__()
        self.layers = nn.ModuleList(Params(t) for t in tree["layers"])
        self.final_norm = nn.Parameter(tree["final_norm"])

    def forward(self, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
        dtype = frames.dtype
        x = frames + sinusoidal(frames.shape[1], cfg.d_model, frames.device,
                                work_dtype(frames)).to(dtype)[None]
        ctx = Ctx(cfg=cfg, mode="train")
        for layer in self.layers:
            x, _ = _self_attention(layer.attn, x, ctx, None, causal=False)
            x = _ffn(layer.ffn, x, cfg)
        return rms_norm(x, self.final_norm)


class Transformer(nn.Module):
    """The model: embedding, ``units`` (a ``ModuleList`` of one
    ``ModuleDict`` of blocks per pattern repetition), the unscanned
    remainder ``rem``, the encoder (enc-dec) and the head.

    ``params`` is the port's layout of the reference's tree:
    ``{"embed", "lm_head", "final_norm"?, "units": [unit tree, ...],
    "rem": {...}?, "encoder": {"layers": [...], "final_norm"}?}``."""

    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.lm_head = nn.Parameter(params["lm_head"])
        self.final_norm = (nn.Parameter(params["final_norm"])
                           if "final_norm" in params else None)
        pat = effective_pattern(cfg)
        self.units = nn.ModuleList(
            nn.ModuleDict({f"b{i}": BLOCKS[k](u[f"b{i}"])
                           for i, k in enumerate(pat)})
            for u in params["units"])
        self.rem = nn.ModuleDict(
            {f"r{i}": BLOCKS[k](params["rem"][f"r{i}"])
             for i, k in enumerate(_rem_kinds(cfg))})
        self.encoder = (Encoder(params["encoder"]) if cfg.family == "encdec"
                        else None)


# ---------------------------------------------------------------------------
# stack driver
# ---------------------------------------------------------------------------

def _run_unit(unit: nn.ModuleDict, x: torch.Tensor, ctx: Ctx,
              unit_cache: dict | None) -> tuple[torch.Tensor, dict | None]:
    new_cache = {}
    for name, block in unit.items():
        c = None if unit_cache is None else unit_cache[name]
        x, nc = block(x, ctx, c)
        if nc is not None:
            new_cache[name] = nc
    if ctx.mode == "train" and ctx.cfg.act_shard == "seq":
        x = shard(x, "batch", "act_seq", None)
    return x, (new_cache or None)


def _train_unit(unit: nn.ModuleDict, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    return _run_unit(unit, x, ctx, None)[0]


def _run_stack(model: Transformer, x: torch.Tensor, ctx: Ctx,
               caches: dict | None) -> tuple[torch.Tensor, dict | None]:
    cfg = ctx.cfg
    # the reference's remat: under autograd a unit's activations are
    # recomputed in the backward pass instead of kept
    remat = (ctx.mode == "train" and cfg.remat != "none"
             and torch.is_grad_enabled())
    new_units = []
    for ui, unit in enumerate(model.units):
        if remat:
            x = checkpoint(_train_unit, unit, x, ctx, use_reentrant=False)
            continue
        uc = caches["units"][ui] if ctx.mode == "decode" else None
        x, nc = _run_unit(unit, x, ctx, uc)
        new_units.append(nc)
    new_caches = None if ctx.mode == "train" else {"units": new_units}
    new_rem = {}
    for name, block in model.rem.items():
        c = caches["rem"][name] if ctx.mode == "decode" else None
        x, nc = block(x, ctx, c)
        if nc is not None:
            new_rem[name] = nc
    if new_caches is not None and new_rem:
        new_caches["rem"] = new_rem
    return x, new_caches


# ---------------------------------------------------------------------------
# public model API
# ---------------------------------------------------------------------------

def _embed(model: Transformer, tokens: torch.Tensor,
           pos_offset: int | None = None) -> torch.Tensor:
    cfg = model.cfg
    dtype = DTYPES[cfg.compute_dtype]
    # one lookup for the plain and the placed model, so that a (1, 1) mesh
    # is bitwise the plain step on the card too (the index form's backward
    # is an index_put, which sums a row's cotangents in another order than
    # F.embedding's, and which DTensor does not shard in every torch
    # version).  On a mesh the table is gathered over each mesh axis that
    # shards the ids (as GSPMD gathers an FSDP-sharded weight): where the
    # ids and the table share an axis DTensor gathers the ids instead but
    # keeps the vocabulary mask of its own rows, whose shape then fails
    # the reduction over the vocabulary's shards
    ids = tokens.long()
    x = torch.nn.functional.embedding(
        ids, _gathered_where_sharded(model.embed, ids)).to(dtype)
    if not cfg.rope_theta:                          # sinusoidal positions
        if pos_offset is None:
            pe = sinusoidal(tokens.shape[1], cfg.d_model, x.device,
                            work_dtype(x))
        else:
            pe = sinusoidal_at(torch.full((1,), float(pos_offset),
                                          dtype=work_dtype(x),
                                          device=x.device), cfg.d_model)
        x = x + pe.to(dtype)[None]
    return shard(x, "batch", "seq", None)


def _gathered_where_sharded(w: torch.Tensor, ids: torch.Tensor
                            ) -> torch.Tensor:
    """DTensor ``w`` replicated on each mesh dimension that shards the
    DTensor ``ids``; ``w`` as it is otherwise."""
    if not (is_dtensor(w) and is_dtensor(ids)):
        return w
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if q.is_shard() else p
               for p, q in zip(w.placements, ids.placements))
    return w if pl == tuple(w.placements) else \
        w.redistribute(w.device_mesh, pl)


def _enc_source(model: Transformer, batch: dict) -> torch.Tensor | None:
    cfg = model.cfg
    dtype = DTYPES[cfg.compute_dtype]
    if cfg.family == "encdec":
        return model.encoder(batch["frames"].to(dtype), cfg)
    if cfg.family == "vlm":
        return batch["patches"].to(dtype)
    return None


def _logits(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    if model.final_norm is not None:
        x = rms_norm(x, model.final_norm)
    elif model.cfg.nonparam_norm:
        x = layer_norm_nonparam(x)
    logits = _replicated(x) @ model.lm_head.to(x.dtype)
    return shard(logits, "batch", "seq", "vocab")


def forward_train(model: Transformer, batch: dict) -> torch.Tensor:
    """Full causal forward → logits [B, S, V]."""
    x = _embed(model, batch["tokens"])
    ctx = Ctx(cfg=model.cfg, mode="train", enc=_enc_source(model, batch))
    x, _ = _run_stack(model, x, ctx, None)
    return _logits(model, x)


def forward_prefill(model: Transformer, batch: dict
                    ) -> tuple[torch.Tensor, dict]:
    """Forward + caches; returns (last-position logits [B, 1, V], caches)."""
    x = _embed(model, batch["tokens"])
    ctx = Ctx(cfg=model.cfg, mode="prefill", enc=_enc_source(model, batch))
    x, caches = _run_stack(model, x, ctx, None)
    return _logits(model, x[:, -1:, :]), caches


def forward_decode(model: Transformer, caches: dict, token: torch.Tensor,
                   pos: int, return_hidden: bool = False):
    """One decode step.  ``token [B, 1]``, ``pos`` the position written
    (a Python int).  ``return_hidden`` also yields the pre-logits hidden
    state (the kNN-softmax head retrieves candidates from it).

    Unlike the reference, which returns new caches and leaves its input
    intact, the attention caches are updated in place (one slot a layer)
    and returned; recurrent states come back as new tensors."""
    pos = int(pos)
    x = _embed(model, token, pos_offset=pos)
    ctx = Ctx(cfg=model.cfg, mode="decode", pos=pos)
    x, new_caches = _run_stack(model, x, ctx, caches)
    logits = _logits(model, x)
    if return_hidden:
        return logits, new_caches, x
    return logits, new_caches


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def _unit_spec(s: PSpec) -> PSpec:
    """One unit's slice of a stacked leaf, with the stacked leaf's stddev
    (``1/sqrt(n_units)`` unless the leaf sets its own)."""
    scale = s.scale if s.scale is not None else default_scale(s.shape)
    return PSpec(s.shape[1:], s.logical[1:], s.init, scale, s.dtype)


def _init_units(stacked: dict, generator: torch.Generator,
                dtype: torch.dtype, device: torch.device) -> list:
    n = leaves(stacked)[0].shape[0]
    unit = map_tree(_unit_spec, stacked)
    return [init_tree(unit, generator, dtype, device) for _ in range(n)]


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Transformer:
    """A model with random parameters drawn from ``generator`` (on its own
    device, then moved to ``device``) with the reference's distributions:
    stddev ``1/sqrt(shape[0])`` of each stacked leaf (``n_units``), 0.02
    for the embedding, ``logit(U(0.9, 0.999))`` for ``rglru_lambda``."""
    device = resolve_device(device)
    dtype = DTYPES[cfg.param_dtype]
    specs = init_specs(cfg)
    params = {k: init_tree(v, generator, dtype, device)
              for k, v in specs.items() if k not in ("stack", "encoder")}
    params["units"] = _init_units(specs["stack"], generator, dtype, device)
    if "encoder" in specs:
        enc = specs["encoder"]
        params["encoder"] = {
            "layers": _init_units(enc["stack"], generator, dtype, device),
            "final_norm": init_one(enc["final_norm"], generator, dtype,
                                   device)}
    return Transformer(cfg, params)


def init_cache(cfg: ArchConfig, batch: int, seq: int,
               device: str | torch.device = "cuda") -> dict:
    """Zero caches of ``seq`` positions, in the reference's dtypes: unit
    caches in ``compute_dtype`` (the reference's stacking drops per-leaf
    dtypes), remainder recurrent states in float32."""
    device = resolve_device(device)
    dtype = DTYPES[cfg.compute_dtype]
    specs = cache_specs(cfg, batch, seq)
    gen = torch.Generator()                         # zeros draw nothing
    out = {"units": _init_units(specs["stack"], gen, dtype, device)}
    if "rem" in specs:
        out["rem"] = init_tree(specs["rem"], gen, dtype, device)
    return out


def grow_cache(caches: dict, prefix: int, total: int) -> dict:
    """Zero-pad the self-attention caches of a ``prefix``-token prefill to
    ``total`` positions, so decode can write positions ``prefix..total-1``
    (recurrent states are constant-size and cross-attention caches hold the
    whole source)."""
    def grow(tree):
        return {k: (grow(v) if isinstance(v, dict) else
                    torch.nn.functional.pad(v, (0, 0, 0, 0, 0, total - prefix))
                    if k in ("k", "v") and v.shape[1] == prefix else v)
                for k, v in tree.items()}
    out = {"units": [grow(u) for u in caches["units"]]}
    if "rem" in caches:
        out["rem"] = grow(caches["rem"])
    return out


def abstract_params(cfg: ArchConfig,
                    device: str | torch.device = "cuda") -> dict:
    """The parameter tree's shapes and dtypes as fake tensors, in the
    stacked layout of :func:`init_specs` (the reference's
    ``abstract_params``)."""
    return abstract(init_specs(cfg), DTYPES[cfg.param_dtype], device)


def abstract_cache(cfg: ArchConfig, batch: int, seq: int,
                   device: str | torch.device = "cuda") -> dict:
    """The cache tree's shapes and dtypes as fake tensors, in the stacked
    layout of :func:`cache_specs`."""
    return abstract(cache_specs(cfg, batch, seq), DTYPES[cfg.compute_dtype],
                    device)


def count_params(cfg: ArchConfig) -> int:
    return sum(math.prod(s.shape) for s in leaves(init_specs(cfg)))
