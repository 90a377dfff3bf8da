"""SAX / iSAX summarization numerics (paper §3) — the port's copy of
``repro.core.sax``.

Conventions used throughout the framework:

* A *data series* is a float32 vector of length ``n`` (z-normalized).
* ``w``  — number of PAA segments (paper default 16).
* ``b``  — bits per SAX symbol; alphabet cardinality ``c = 2**b`` (default
  ``b=8 → c=256``, the standard iSAX-family configuration).
* A SAX *symbol* is the full-resolution ``b``-bit region id, an integer in
  ``[0, c)``.  Region ``r`` covers the value interval
  ``[bp_ext[r], bp_ext[r+1])`` where ``bp_ext`` is the breakpoint table
  extended with ``-inf`` / ``+inf`` at the two ends.
* An iSAX symbol is a *prefix* of the SAX symbol: ``(symbol, card)`` where
  ``card`` is the number of bits used (``0 ≤ card ≤ b``; ``card == 0`` is the
  paper's ``*`` wildcard covering the whole real line).  The prefix value of a
  full-resolution symbol ``s`` at cardinality ``card`` is ``s >> (b - card)``.
* Bit order: the *most significant* bit of a symbol is the first split bit
  (the coarsest subdivision), matching the iSAX family.

The numpy half (host, index construction) is a verbatim copy, so host
builds are bitwise those of the reference; the torch half
(:func:`sax_encode_t`) is the plain version of the hand-written CUDA
encoder in ``repro_torch.kernels.sax_encode``.
"""
from __future__ import annotations

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy.special import ndtri

# sax_encode_np's chunks of a large collection, and the threads that encode
# them
ENCODE_ROWS, ENCODE_WORKERS = 1 << 16, 4


@dataclasses.dataclass(frozen=True)
class SaxParams:
    """Static summarization parameters (paper §7 defaults)."""

    w: int = 16          # number of PAA segments
    b: int = 8           # bits per symbol (cardinality c = 2**b)

    @property
    def c(self) -> int:
        return 1 << self.b

    def validate_series_length(self, n: int) -> None:
        if n % self.w != 0:
            raise ValueError(
                f"series length n={n} must be divisible by w={self.w}; "
                f"pad the series (repro_torch.data.series.pad_to_multiple) "
                f"first")


# ---------------------------------------------------------------------------
# Breakpoints
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def breakpoints(b: int) -> np.ndarray:
    """``c-1`` N(0,1) quantile breakpoints separating the ``c = 2**b`` regions.

    ``bp[i] = Phi^{-1}((i+1)/c)``; region ``r`` is ``[bp[r-1], bp[r])`` with
    the two edge regions unbounded.
    """
    c = 1 << b
    qs = np.arange(1, c, dtype=np.float64) / c
    return np.asarray(ndtri(qs), dtype=np.float64)


@functools.lru_cache(maxsize=None)
def breakpoints_ext(b: int) -> np.ndarray:
    """Breakpoints extended with ``-inf`` / ``+inf``: length ``c + 1``."""
    bp = breakpoints(b)
    return np.concatenate([[-np.inf], bp, [np.inf]])


@functools.lru_cache(maxsize=None)
def region_midpoints(b: int) -> np.ndarray:
    """Representative value of each of the ``c`` regions (paper footnote 2).

    Interior regions use the arithmetic midpoint of their value range.  The
    two unbounded edge regions use the *median of the Gaussian mass* inside
    the region (``Phi^{-1}(1/(2c))`` / ``Phi^{-1}(1 - 1/(2c))``) so that the
    statistic is finite and distribution-faithful.
    """
    c = 1 << b
    bpe = breakpoints_ext(b)
    mid = (bpe[:-1] + bpe[1:]) / 2.0
    mid[0] = ndtri(1.0 / (2 * c))
    mid[-1] = ndtri(1.0 - 1.0 / (2 * c))
    return mid.astype(np.float64)


# ---------------------------------------------------------------------------
# PAA + SAX encoding
# ---------------------------------------------------------------------------

def paa_np(x: np.ndarray, w: int) -> np.ndarray:
    """Piecewise Aggregate Approximation.  ``x: [..., n] -> [..., w]``."""
    n = x.shape[-1]
    if n % w:
        raise ValueError(f"n={n} not divisible by w={w}")
    return x.reshape(*x.shape[:-1], w, n // w).mean(axis=-1)


def sax_from_paa_np(paa: np.ndarray, b: int) -> np.ndarray:
    """Symbolize PAA coefficients → uint8 region ids (host)."""
    bp = breakpoints(b)
    return np.searchsorted(bp, paa, side="right").astype(np.uint8)


def sax_encode_np(x: np.ndarray, params: SaxParams) -> tuple[np.ndarray, np.ndarray]:
    """Host encoder: ``x [N, n]`` → ``(paa [N, w] float32, sax [N, w]
    uint8)``.

    Encoded in chunks of ``ENCODE_ROWS`` rows, several chunks on
    ``ENCODE_WORKERS`` threads: each row's float64 mean is its own, so the
    chunks change no bit, and no float64 copy of the whole collection is
    held."""
    x = np.asarray(x)
    paa = np.empty((x.shape[0], params.w), np.float32)
    sax = np.empty((x.shape[0], params.w), np.uint8)

    def encode(r0: int) -> None:
        rows = slice(r0, r0 + ENCODE_ROWS)
        p = paa_np(np.asarray(x[rows], dtype=np.float64), params.w)
        paa[rows] = p
        sax[rows] = sax_from_paa_np(p, params.b)

    starts = range(0, x.shape[0], ENCODE_ROWS)
    if len(starts) > 1:
        with ThreadPoolExecutor(max_workers=ENCODE_WORKERS) as pool:
            list(pool.map(encode, starts))
    else:
        for r0 in starts:
            encode(r0)
    return paa, sax


def paa_t(x: torch.Tensor, w: int) -> torch.Tensor:
    """PAA as the segment mean, in the tensor's dtype and on its device."""
    n = x.shape[-1]
    if n % w:
        raise ValueError(f"n={n} not divisible by w={w}")
    return x.reshape(*x.shape[:-1], w, n // w).mean(dim=-1)


@functools.lru_cache(maxsize=None)
def breakpoints_t(b: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """:func:`breakpoints` as a tensor, uploaded once per (b, dtype, device)
    rather than on every encode."""
    return torch.as_tensor(breakpoints(b), dtype=dtype, device=device)


def sax_from_paa_t(paa: torch.Tensor, b: int) -> torch.Tensor:
    """Symbol = number of breakpoints ≤ PAA (searchsorted right), uint8."""
    bp = breakpoints_t(b, paa.dtype, paa.device)
    return torch.searchsorted(bp, paa.contiguous(), right=True).to(torch.uint8)


def sax_encode_t(x: torch.Tensor, w: int, b: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch encoder, the twin of ``repro.core.sax.sax_encode_jnp``:
    ``x [..., n]`` → ``(paa [..., w] f32, sax [..., w] uint8)``.  The CUDA
    kernel (``repro_torch.kernels.sax_encode``) is checked against it."""
    p = paa_t(x.to(torch.float32), w)
    return p, sax_from_paa_t(p, b)


# ---------------------------------------------------------------------------
# iSAX region bounds
# ---------------------------------------------------------------------------

def isax_bounds_np(sym: np.ndarray, card: np.ndarray, b: int) -> tuple[np.ndarray, np.ndarray]:
    """Value-range covered by iSAX prefixes.

    ``sym`` holds *prefix values* (``card`` significant bits, right aligned);
    ``card`` the per-entry cardinality in bits (0 = wildcard ``*``).  Returns
    ``(lo, hi)`` float64 arrays of the same shape; wildcards get ``(-inf, inf)``.
    """
    sym = np.asarray(sym, dtype=np.int64)
    card = np.asarray(card, dtype=np.int64)
    bpe = breakpoints_ext(b)
    shift = b - card
    lo_idx = sym << shift
    hi_idx = (sym + 1) << shift
    return bpe[lo_idx], bpe[hi_idx]


def prefix_np(sax: np.ndarray, card: np.ndarray, b: int) -> np.ndarray:
    """Extract the ``card``-bit prefix of full-resolution symbols."""
    return np.asarray(sax, dtype=np.int64) >> (b - np.asarray(card, dtype=np.int64))


def next_bits_np(sax: np.ndarray, card: np.ndarray, b: int) -> np.ndarray:
    """The next refinement bit per symbol: bit ``b-1-card`` of ``sax``.

    ``sax: [N, w] uint8``, ``card: [w]`` → ``[N, w]`` in {0,1}.  Segments
    already at full cardinality (``card == b``) return 0 (callers must not
    split them further).
    """
    card = np.asarray(card, dtype=np.int64)
    shift = np.maximum(b - 1 - card, 0)
    return (np.asarray(sax, dtype=np.int64) >> shift[None, :]) & 1


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """Pack ``[N, m]`` {0,1} columns into integer codes, column 0 = MSB."""
    m = bits.shape[1]
    weights = (1 << np.arange(m - 1, -1, -1, dtype=np.int64))
    return (np.asarray(bits, dtype=np.int64) * weights[None, :]).sum(axis=1)


def extract_bits_np(codes: np.ndarray, positions: list[int] | np.ndarray, m: int) -> np.ndarray:
    """From ``m``-bit codes (bit 0 of the *positions* axis = MSB), extract the
    bits at ``positions`` (ascending) and repack them (first position = MSB).

    This is the paper's ``extract bits in csl from sid`` (Alg. 2 line 26).
    """
    codes = np.asarray(codes, dtype=np.int64)
    positions = np.asarray(positions, dtype=np.int64)
    k = len(positions)
    out = np.zeros_like(codes)
    for i, p in enumerate(positions):
        bit = (codes >> (m - 1 - p)) & 1
        out |= bit << (k - 1 - i)
    return out


# ---------------------------------------------------------------------------
# Device-side helper of the distributed build
# ---------------------------------------------------------------------------

def next_bit_codes_t(sax: torch.Tensor, card: torch.Tensor, w: int, b: int
                     ) -> torch.Tensor:
    """Vectorized ``next_bits`` + ``pack_bits`` on the symbols' device (the
    twin of ``repro.core.sax.next_bit_codes_jnp``): ``[N, w]`` symbols at
    cardinalities ``card [w]`` → ``[N]`` int32 codes, segment 0 the most
    significant bit.  Feeds the ``2**w`` root histogram of
    ``core.distributed.build_step``."""
    shift = torch.clamp_min(b - 1 - card.to(torch.int32), 0)
    bits = (sax.to(torch.int32) >> shift[None, :]) & 1
    weights = torch.bitwise_left_shift(
        torch.ones(w, dtype=torch.int32, device=sax.device),
        torch.arange(w - 1, -1, -1, dtype=torch.int32, device=sax.device))
    return (bits * weights[None, :]).sum(dim=1, dtype=torch.int32)
