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
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import local, shard

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}


def work_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype of the reference's float32 arithmetic on operand ``x``:
    float64 for a float64 operand, float32 for any other.  A float64 step
    (``param_dtype`` and ``compute_dtype`` ``"float64"``) is a check of a
    placement, held to one device's float64 step; no preset offers it."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


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
# sequence loops (the reference's lax.scan over time or chunks)
# ---------------------------------------------------------------------------

def untracked(*ts) -> bool:
    """Whether autograd records nothing for ops on ``ts`` (so their
    float32 temporaries may be updated in place)."""
    return not (torch.is_grad_enabled() and
                any(t is not None and t.requires_grad for t in ts))


def _trips(name: str, trips: int, body, carry):
    """``carry = body(i, carry)`` for ``i`` in ``range(trips)``; under a
    dry-run count (``op_cost.counting``) trip 0 alone, its work counted
    ``trips`` times (``op_cost.scaled``)."""
    from repro_torch.distributed import op_cost
    if op_cost.counting():
        return op_cost.scaled(name, trips, body, 0, carry)
    for i in range(trips):
        carry = body(i, carry)
    return carry


def _seq_forward(name, step, length, carry, xs, consts, ys, saved):
    """:func:`scan`'s loop: trip ``i`` reads ``xs[:, i*length:][:length]``,
    writes its output there in ``ys`` and, where ``saved`` is given, the
    carry it started from at ``saved[j][i]``."""
    def body(i, carry):
        lo = i * length
        if saved is not None:
            for buf, c in zip(saved, carry):
                buf[i].copy_(c)
        carry, y = step(carry, tuple(x[:, lo:lo + length] for x in xs),
                        consts)
        ys[:, lo:lo + length].copy_(y)
        return carry
    return _trips(name, ys.shape[1] // length, body, tuple(carry))


class _Scan(torch.autograd.Function):
    """:func:`scan` under autograd: the forward runs the loop without a
    graph and keeps the carry each trip started from; the backward walks
    the trips in reverse, each recomputing its step from its saved carry
    and taking that step's vector-Jacobian product (the reference's
    ``lax.scan`` transpose).  Both loops count by trip in a dry run."""

    @staticmethod
    def forward(ctx, meta, *tensors):
        name, step, length, n_carry, n_xs, out_shape, out_dtype = meta
        carry = tensors[:n_carry]
        xs = tensors[n_carry:n_carry + n_xs]
        consts = tensors[n_carry + n_xs:]
        trips = out_shape[1] // length
        ys = torch.empty(out_shape, dtype=out_dtype, device=xs[0].device)
        saved = tuple(torch.empty((trips,) + tuple(c.shape), dtype=c.dtype,
                                  device=c.device) for c in carry)
        final = _seq_forward(name, step, length, carry, xs, consts, ys,
                             saved)
        ctx.meta = meta
        ctx.save_for_backward(*xs, *consts, *saved)
        return (ys, *final)

    @staticmethod
    def backward(ctx, g_ys, *g_final):
        name, step, length, n_carry, n_xs, out_shape, _ = ctx.meta
        stored = ctx.saved_tensors
        xs = stored[:n_xs]
        consts = stored[n_xs:len(stored) - n_carry]
        saved = stored[len(stored) - n_carry:]
        need = ctx.needs_input_grad[1:]
        x_grad = need[n_carry:n_carry + n_xs]
        k_grad = need[n_carry + n_xs:]
        trips = out_shape[1] // length
        g_xs = tuple(torch.empty_like(x) if w else None
                     for x, w in zip(xs, x_grad))
        g_consts = tuple(torch.zeros_like(k) if w else None
                         for k, w in zip(consts, k_grad))
        if g_ys is None:
            g_ys = torch.zeros(out_shape, dtype=ctx.meta[6],
                               device=xs[0].device)
        g = tuple(torch.zeros_like(s[0]) if gf is None else gf
                  for s, gf in zip(saved, g_final))
        k_in = tuple(k.detach().requires_grad_(w)
                     for k, w in zip(consts, k_grad))

        def body(j, g):
            i = trips - 1 - j
            lo = i * length
            with torch.enable_grad():
                c_in = tuple(s[i].detach().requires_grad_() for s in saved)
                x_in = tuple(x[:, lo:lo + length].detach().requires_grad_(w)
                             for x, w in zip(xs, x_grad))
                new, y = step(c_in, x_in, k_in)
                wrt = c_in + tuple(x for x, w in zip(x_in, x_grad) if w) + \
                    tuple(k for k, w in zip(k_in, k_grad) if w)
                grads = torch.autograd.grad(
                    (*new, y), wrt, (*g, g_ys[:, lo:lo + length]),
                    allow_unused=True)
            g_carry = tuple(torch.zeros_like(c) if d is None else d
                            for c, d in zip(c_in, grads[:n_carry]))
            rest = iter(grads[n_carry:])
            for gx in g_xs:
                if gx is not None:
                    gx[:, lo:lo + length].copy_(next(rest))
            for gk in g_consts:
                if gk is not None:
                    d = next(rest)
                    if d is not None:
                        gk.add_(d)
            return g_carry
        g0 = _trips(f"{name}.backward", trips, body, g)
        return (None, *g0, *g_xs, *g_consts)


def scan(name: str, step, length: int, carry: tuple, xs: tuple,
         consts: tuple, out_shape: tuple, out_dtype: torch.dtype
         ) -> tuple[torch.Tensor, tuple]:
    """A loop over a sequence in trips of ``length`` positions (the
    reference's ``lax.scan`` over time or chunks).  ``step(carry, xs_i,
    consts) -> (carry, y_i)`` with ``xs_i`` each of ``xs`` sliced to the
    trip along dim 1 and ``y_i`` its ``length`` positions of the output.
    Each ``y_i`` is written in place into one ``out_shape`` buffer, so the
    carry is the loop's only state; returns ``(ys, final carry)``.

    Every trip runs, except inside a dry-run count (``op_cost.analyze``),
    where one trip runs and counts ``trips`` times (``op_cost.scaled``),
    its backward too.  Under autograd the loop is a :class:`_Scan`: the
    backward recomputes each trip from the carry it started from."""
    tensors = (*carry, *xs, *consts)
    if not untracked(*tensors):
        meta = (name, step, length, len(carry), len(xs), tuple(out_shape),
                out_dtype)
        out = _Scan.apply(meta, *tensors)
        return out[0], tuple(out[1:])
    ys = torch.empty(out_shape, dtype=out_dtype, device=xs[0].device)
    final = _seq_forward(name, step, length, carry, xs, consts, ys, None)
    return ys, final


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor | None,
             eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm: scales by ``1 + scale`` (``torch.nn.RMSNorm``
    multiplies by the weight itself).  Without autograd the float32 copy
    is scaled in place (the same values, one ``[.., D]`` temporary
    fewer); under it the norm is checkpointed, so its backward recomputes
    the float32 copies from ``x`` instead of keeping them."""
    if not untracked(x, scale):
        return checkpoint(_rms_norm, x, scale, eps, use_reentrant=False,
                          preserve_rng_state=False)
    x32 = x.to(work_dtype(x))
    r = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    y = x32.mul_(r) if x32 is not x else x32 * r
    if scale is not None:
        y.mul_(1.0 + scale.to(x32.dtype))
    return y.to(x.dtype)


def _rms_norm(x, scale, eps: float):
    x32 = x.to(work_dtype(x))
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.to(x32.dtype))
    return y.to(x.dtype)


def layer_norm_nonparam(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm (no scale/bias); without autograd
    the centred copy is scaled in place (the same values), under it the
    norm is checkpointed (as :func:`rms_norm`)."""
    if not untracked(x):
        return checkpoint(_layer_norm_nonparam, x, eps, use_reentrant=False,
                          preserve_rng_state=False)
    x32 = x.to(work_dtype(x))
    mu = x32.mean(-1, keepdim=True)
    c = x32.sub_(mu) if x32 is not x else x32 - mu
    var = (c ** 2).mean(-1, keepdim=True)
    return c.mul_(torch.rsqrt(var + eps)).to(x.dtype)


def _layer_norm_nonparam(x, eps: float):
    x32 = x.to(work_dtype(x))
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
    wd = work_dtype(x)
    exps = -torch.arange(0, half, dtype=wd, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=wd, device=x.device), exps)
    ang = pos[..., None].to(wd) * freqs                      # [S, half]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings of the float positions ``pos [S]`` → ``[S, d]``,
    in :func:`work_dtype` of ``pos``."""
    wd = work_dtype(pos)
    dim = torch.arange(d // 2, dtype=wd, device=pos.device)[None, :]
    ang = pos.to(wd)[:, None] / (10_000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal(seq: int, d: int, device=None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return sinusoidal_at(torch.arange(seq, dtype=dtype, device=device), d)


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
    """Rounds to bfloat16 (held in ``x``'s dtype); the gradient passes
    through."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

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
        return g.to(torch.bfloat16).to(g.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: int = 0, chunk: int = 1024
              ) -> torch.Tensor:
    """Chunked online-softmax attention with the reference's arithmetic.

    ``q [B, Sq, H, D]``; ``k/v [B, Sk, KV, D]`` (GQA broadcast inside).  A
    loop over KV chunks carries (max, denom, acc) in float32 (float64 for
    float64 operands, :func:`work_dtype`): masked logits
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
    """:func:`attention`'s chunk loop over heads already broadcast.  Under
    autograd it is a :class:`_ChunkedAttention`, which recomputes each
    chunk's logits in the backward pass, as the reference's
    ``jax.checkpoint(step)``, instead of keeping ``[B, H, Sq, chunk]``
    residuals for every chunk.  Without autograd a chunk's float32
    temporaries are updated in place (the same values)."""
    b, sq, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    chunk = min(chunk, k.shape[1])
    # the scaled query, rounded to the key dtype, as float32 operands
    wd = work_dtype(q)
    qf = (q.to(wd) * scale).to(k.dtype).to(wd)
    if not untracked(q, k, v):
        _, l, acc = _ChunkedAttention.apply(qf, k, v, causal, window, chunk)
    else:
        m, l, acc = _attention_init(qf)
        for lo in range(0, k.shape[1], chunk):
            m, l, acc = _attention_chunk_inplace(
                qf, k[:, lo:lo + chunk], v[:, lo:lo + chunk], m, l, acc, lo,
                causal, window)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                # [B, Sq, H, D]


def _attention_init(qf: torch.Tensor) -> tuple:
    """The online softmax's first carry ``(m, l, acc)``."""
    b, sq, h, d = qf.shape
    return (torch.full((b, h, sq), -math.inf, dtype=qf.dtype,
                       device=qf.device),
            torch.zeros((b, h, sq), dtype=qf.dtype, device=qf.device),
            torch.zeros((b, h, sq, d), dtype=qf.dtype, device=qf.device))


class _ChunkedAttention(torch.autograd.Function):
    """The chunk loop under autograd (the reference's
    ``lax.scan(jax.checkpoint(step))``): the forward runs the chunks
    without a graph and keeps the carry ``(m, l, acc)`` each started from;
    the backward walks the chunks in reverse, each recomputed from its
    carry and its vector-Jacobian product taken, the query's gradient
    summed over the chunks in the order autograd would sum it."""

    @staticmethod
    def forward(ctx, qf, k, v, causal: bool, window: int, chunk: int):
        carry = _attention_init(qf)
        saved = []
        for lo in range(0, k.shape[1], chunk):
            saved.extend(carry)
            carry = _attention_chunk(qf, k[:, lo:lo + chunk],
                                     v[:, lo:lo + chunk], *carry, lo,
                                     causal, window)
        ctx.args = (causal, window, chunk)
        ctx.save_for_backward(qf, k, v, *saved)
        return carry

    @staticmethod
    def backward(ctx, *g_out):
        causal, window, chunk = ctx.args
        qf, k, v, *saved = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        g_q = torch.zeros_like(qf) if need_q else None
        g_k = torch.empty_like(k) if need_k else None
        g_v = torch.empty_like(v) if need_v else None
        g = [torch.zeros_like(c) if gc is None else gc
             for c, gc in zip(saved[:3], g_out)]
        q_in = qf.detach().requires_grad_(need_q)
        for ci in reversed(range(len(saved) // 3)):
            lo = ci * chunk
            first = ci == 0           # the first carry is a constant
            with torch.enable_grad():
                c_in = [c.detach().requires_grad_(not first)
                        for c in saved[3 * ci:3 * ci + 3]]
                kb = k[:, lo:lo + chunk].detach().requires_grad_(need_k)
                vb = v[:, lo:lo + chunk].detach().requires_grad_(need_v)
                out = _attention_chunk(q_in, kb, vb, *c_in, lo, causal,
                                       window)
                wrt = [t for t in (*c_in, q_in, kb, vb) if t.requires_grad]
                grads = iter(torch.autograd.grad(out, wrt, g,
                                                 allow_unused=True))
            if not first:
                g = [next(grads) for _ in range(3)]
            if need_q:
                g_q.add_(next(grads))
            for buf in (g_k, g_v):
                if buf is not None:
                    buf[:, lo:lo + chunk].copy_(next(grads))
        return g_q, g_k, g_v, None, None, None


def _chunk_mask(sq: int, lo: int, ck: int, causal: bool, window: int,
                device) -> torch.Tensor:
    """Which (query, key) pairs of the chunk at ``lo`` attend."""
    qpos = torch.arange(sq, device=device)
    kpos = lo + torch.arange(ck, device=device)
    mask = torch.ones((sq, ck), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    return mask


def _attention_chunk(qf, kb, vb, m, l, acc, lo: int, causal: bool,
                     window: int):
    """One KV chunk (``kb, vb``, the keys from ``lo``) of the online
    softmax: the carry ``(m, l, acc)`` → the next.  Masked logits are
    ``-1e30`` while the running max starts at ``-inf``; the probabilities
    are rounded to bf16 for the PV product."""
    kb, vb = kb.to(qf.dtype), vb.to(qf.dtype)             # [B, C, H, D]
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
    logits = shard(logits, "batch", "heads", None, None)
    mask = _chunk_mask(qf.shape[1], lo, kb.shape[1], causal, window,
                       qf.device)
    logits = torch.where(mask[None, None], logits, -1e30)
    m_new = torch.maximum(m, logits.amax(-1))
    # probabilities rounded to bf16 for the PV product (values ≤ 1;
    # f32 sums), each use's gradient rounded to bf16 on its own
    p = _RoundBF16.apply(torch.exp(logits - m_new[..., None]))
    corr = torch.exp(m - m_new)
    l = l * corr + _GradRoundBF16.apply(p).sum(-1)
    pv = torch.einsum("bhqk,bkhd->bhqd", _GradRoundBF16.apply(p), vb)
    acc = acc * corr[..., None] + pv
    return m_new, l, acc


def _attention_chunk_inplace(qf, kb, vb, m, l, acc, lo: int, causal: bool,
                             window: int):
    """:func:`_attention_chunk` without autograd: the logits masked,
    shifted and exponentiated in place, the accumulator updated in place
    (the same values, op for op)."""
    kb, vb = kb.to(qf.dtype), vb.to(qf.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
    logits = shard(logits, "batch", "heads", None, None)
    mask = _chunk_mask(qf.shape[1], lo, kb.shape[1], causal, window,
                       qf.device)
    logits.masked_fill_(~mask[None, None], -1e30)
    m_new = torch.maximum(m, logits.amax(-1))
    p = logits.sub_(m_new[..., None]).exp_().to(torch.bfloat16)
    del logits
    p = p.to(qf.dtype)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bhqd", p, vb)
    del p
    acc.mul_(corr[..., None]).add_(pv)
    return m_new, l, acc


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
