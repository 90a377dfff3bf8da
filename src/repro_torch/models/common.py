"""Shared model building blocks (port of ``repro.models.common``).

Parameters are described by ``PSpec`` trees (shape + logical axes + init);
:func:`init_params` draws a spec tree's tensors from a ``torch.Generator``
with the reference's distributions.  Norms, positions, attention and the
FFNs are plain functions on tensors with the reference's arithmetic: where
it asks for ``preferred_element_type=float32`` on low-precision operands,
the operands are cast to float32 first, and the attention's online softmax
is a loop over KV chunks (``scaled_dot_product_attention`` rounds
differently).  Activations are annotated through
``repro_torch.distributed.sharding.shard`` at the reference's sites.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import local, shard

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "normal"       # 'normal' | 'zeros' | 'ones' | 'rglru_lambda'
    scale: float | None = None  # stddev override (default 1/sqrt(fan_in))
    dtype: str | None = None   # per-leaf override (e.g. f32 recurrent states)


def map_tree(fn, tree: Any) -> Any:
    """``fn`` over the leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def zip_tree(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of a tree of dicts and lists and the leaves
    at the same places in the trees ``rest``."""
    if isinstance(tree, dict):
        return {k: zip_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [zip_tree(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaves(tree: Any) -> list:
    """The leaves of a tree of dicts and lists, keys in sorted order (the
    order ``jax.tree.leaves`` walks a dict)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def default_scale(shape: tuple[int, ...]) -> float:
    """The reference's default stddev: ``1/sqrt(shape[0])`` for a leaf of
    two or more dimensions (so ``n_units`` on a stacked leaf), else
    ``1/sqrt(shape[-1])``."""
    fan = shape[0] if len(shape) > 1 else shape[-1]
    return 1.0 / math.sqrt(max(fan, 1))


def init_one(spec: PSpec, generator: torch.Generator, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """One leaf of :func:`init_params`, drawn on the generator's device and
    moved to ``device``."""
    dt = DTYPES[spec.dtype] if spec.dtype else dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    gdev = generator.device
    if spec.init == "rglru_lambda":   # a = sigmoid(Λ) ∈ (0.9, 0.999)
        u = torch.empty(spec.shape, dtype=torch.float32, device=gdev)
        u.uniform_(0.9, 0.999, generator=generator)
        return torch.log(u / (1 - u)).to(device=device, dtype=dt)
    scale = spec.scale if spec.scale is not None else default_scale(spec.shape)
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=gdev)
    return (scale * x).to(device=device, dtype=dt)


def init_params(tree: Any, generator: torch.Generator, dtype: torch.dtype,
                device: torch.device) -> Any:
    """A spec tree's tensors (``repro.models.common.materialize``): each
    leaf drawn from ``generator`` with the reference's distribution (the
    ``jax.random`` streams themselves cannot be reproduced)."""
    return map_tree(lambda s: init_one(s, generator, dtype, device), tree)


def logical_tree(tree: Any) -> Any:
    """A spec tree's logical axis names, leaf by leaf."""
    return map_tree(lambda s: s.logical, tree)


def abstract(tree: Any, dtype: torch.dtype,
             device: str | torch.device = "cuda") -> Any:
    """A spec tree's shapes and dtypes as fake tensors on ``device`` (the
    reference's ``ShapeDtypeStruct`` tree; a leaf's own dtype wins), made
    in the active ``FakeTensorMode`` or a new one.  Nothing is allocated.
    CUDA unless the caller asks for the CPU; raises without CUDA."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.device_index import resolve_device
    device = resolve_device(device)
    mode = detect_fake_mode() or FakeTensorMode()
    with mode:
        return map_tree(lambda s: torch.empty(
            s.shape, dtype=DTYPES[s.dtype] if s.dtype else dtype,
            device=device), tree)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor | None,
             eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm: scales by ``1 + scale`` (``torch.nn.RMSNorm``
    multiplies by the weight itself)."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(x.dtype)


def layer_norm_nonparam(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm (no scale/bias)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def norm(x: torch.Tensor, scale: torch.Tensor | None,
         nonparam: bool) -> torch.Tensor:
    return layer_norm_nonparam(x) if nonparam else rms_norm(x, scale)


# ---------------------------------------------------------------------------
# rotary / sinusoidal positions
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [B, S, H, D]``, ``pos [S]`` — rotate the two halves of each head
    (NeoX style, not interleaved pairs)."""
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    ang = pos[..., None].float() * freqs                     # [S, half]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings of the float positions ``pos [S]`` → ``[S, d]``."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)[None, :]
    ang = pos.float()[:, None] / (10_000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal(seq: int, d: int, device=None) -> torch.Tensor:
    return sinusoidal_at(torch.arange(seq, dtype=torch.float32,
                                      device=device), d)


# ---------------------------------------------------------------------------
# attention (full / causal / local / cached decode) with chunked softmax
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, D] → [B, S, KV*n_rep, D] (GQA broadcast: head h reads kv
    head h // n_rep)."""
    if n_rep == 1:
        return k
    b, s, kv, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(
        b, s, kv * n_rep, d)


class _RoundBF16(torch.autograd.Function):
    """Rounds to bfloat16 (held in float32); the gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g


class _GradRoundBF16(torch.autograd.Function):
    """The identity, whose gradient is rounded to bfloat16.

    With ``_RoundBF16`` this is the reference's compiled gradient of
    ``p = x.astype(bfloat16)`` used twice: each use's cotangent is rounded
    to bf16 and XLA, allowed excess precision, adds the two in float32
    (autograd on a bf16 ``p`` would round the sum too: ~3e-3 of the
    query and key gradients apart)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: int = 0, chunk: int = 1024
              ) -> torch.Tensor:
    """Chunked online-softmax attention with the reference's arithmetic.

    ``q [B, Sq, H, D]``; ``k/v [B, Sk, KV, D]`` (GQA broadcast inside).  A
    loop over KV chunks carries (max, denom, acc) in float32: masked logits
    are ``-1e30`` while the running max starts at ``-inf``, and the
    probabilities are rounded to bfloat16 for the PV product (``l`` sums
    the rounded values) whatever the compute dtype.  ``window > 0`` adds a
    local-attention band.
    """
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, h // kv)
    v = _repeat_kv(v, h // kv)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "heads", None)
    v = shard(v, "batch", "seq", "heads", None)
    # on a mesh each device runs the loop on its own batch rows and heads
    # (a product over b and h folded into one dimension has no sharding)
    names = ("batch", "seq", "heads", None)
    return local(_attention_core, (names,) * 3, names)(
        q, k, v, causal=causal, window=window, chunk=chunk)


def _attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int, chunk: int) -> torch.Tensor:
    """:func:`attention`'s chunk loop over heads already broadcast."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    chunk = min(chunk, sk)
    n_chunks = -(-sk // chunk)
    # the scaled query, rounded to the key dtype, as float32 operands
    qf = (q.float() * scale).to(k.dtype).float()
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        lo = ci * chunk
        kb = k[:, lo:lo + chunk].float()                  # [B, C, H, D]
        vb = v[:, lo:lo + chunk].float()
        kpos = lo + torch.arange(kb.shape[1], device=q.device)
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        logits = shard(logits, "batch", "heads", None, None)
        mask = torch.ones((sq, kb.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window:
            mask &= qpos[:, None] - kpos[None, :] < window
        logits = torch.where(mask[None, None], logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        # probabilities rounded to bf16 for the PV product (values ≤ 1;
        # f32 sums), each use's gradient rounded to bf16 on its own
        p = _RoundBF16.apply(torch.exp(logits - m_new[..., None]))
        corr = torch.exp(m - m_new)
        l = l * corr + _GradRoundBF16.apply(p).sum(-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", _GradRoundBF16.apply(p), vb)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                # [B, Sq, H, D]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """One-token attention over a full cache.  ``q [B, 1, H, D]``, caches
    ``[B, S, KV, D]`` with valid entries ``<= pos``; logits and the PV
    product in float32 from operands in the cache's dtype."""
    b, _, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    k = _repeat_kv(k_cache, h // kv)
    v = _repeat_kv(v_cache, h // kv)
    k = shard(k, "batch", "cache_seq", None, None)
    v = shard(v, "batch", "cache_seq", None, None)
    q = shard(q, "batch", None, None, None)
    scale = 1.0 / math.sqrt(d)
    qk = (q.float() * scale).to(k.dtype).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qk, k.float())
    logits = shard(logits, "batch", None, None, "cache_seq")
    valid = (torch.arange(s, device=q.device) <= pos)[None, None, None, :]
    logits = torch.where(valid, logits, -1e30)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(k.dtype).float(), v.float())
    out = out / denom.transpose(1, 2)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g) * u
    h = shard(h, "batch", "seq", "mlp")
    return h @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form (``jax.nn.gelu``'s default)."""
    h = F.gelu(x @ w_up, approximate="tanh")
    h = shard(h, "batch", "seq", "mlp")
    return h @ w_down
