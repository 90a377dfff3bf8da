"""Leaf-node packing (paper §5.4, Algorithm 3).

After a split, sibling leaves that are small (< ``r * th`` series) are merged
into *packs*.  A pack is identified by a ``(value, mask)`` pair over the
parent's ``lambda``-bit sid space: ``mask`` bits are *demoted* (wildcard ``*``)
positions; all member sids agree on the non-masked bits.  The number of
demoted bits is capped at ``rho * lambda`` so the pack keeps a tight iSAX
word — this is what preserves pruning power vs. TARDIS-style size-only
partitions (paper §5.4).

The pack is the unit of contiguous device-memory layout (DESIGN.md §2):
the fewer, fuller packs Dumpy produces translate directly into fewer,
larger sequential reads during search.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def popcount(x: int) -> int:
    return bin(x).count("1")


_POP16: np.ndarray | None = None


def _popcount_arr(x: np.ndarray) -> np.ndarray:
    """Vector popcount for int64 arrays (16-bit table, 4 lookups)."""
    global _POP16
    if _POP16 is None:
        t = np.arange(1 << 16, dtype=np.int64)
        t = (t & 0x5555) + ((t >> 1) & 0x5555)
        t = (t & 0x3333) + ((t >> 2) & 0x3333)
        t = (t & 0x0F0F) + ((t >> 4) & 0x0F0F)
        _POP16 = (t & 0x00FF) + ((t >> 8) & 0x00FF)
    x = np.asarray(x, np.int64)
    return (_POP16[x & 0xFFFF] + _POP16[(x >> 16) & 0xFFFF]
            + _POP16[(x >> 32) & 0xFFFF] + _POP16[(x >> 48) & 0xFFFF])


@dataclasses.dataclass
class Pack:
    value: int              # representative sid (non-masked bits meaningful)
    mask: int               # demoted (wildcard) bit positions
    size: int
    members: list[int]      # indices into the sibling-leaf list

    def demotion_bits(self) -> int:
        return popcount(self.mask)

    def try_cost(self, sid: int) -> int:
        """Additional demotion bits if ``sid`` joined this pack."""
        new_mask = self.mask | ((self.value ^ sid) & ~self.mask)
        return popcount(new_mask) - popcount(self.mask)

    def insert(self, sid: int, size: int, member: int) -> None:
        self.mask |= (self.value ^ sid) & ~self.mask
        self.size += size
        self.members.append(member)


def pack_leaves(sids: list[int], sizes: list[int], lam: int, *,
                th: int, r: float = 1.0, rho: float = 0.5,
                seed: int = 0) -> list[Pack]:
    """Algorithm 3.  ``sids``/``sizes`` describe the *small* sibling leaves of
    one parent (callers pre-filter with ``size < r * th``).  Returns packs
    covering every input leaf exactly once.

    Faithful details: the pack list is seeded with ``floor(sum_size / th)``
    randomly chosen leaves (Alg. 3 line 6); each remaining leaf joins the
    feasible pack with least demotion cost (ties → first), else opens a new
    pack; feasibility = pack size stays ≤ th *and* demotion bits stay
    ≤ rho * lambda.
    """
    n = len(sids)
    if n == 0:
        return []
    sids_a = np.asarray(sids, np.int64)
    sizes_a = np.asarray(sizes, np.int64)
    max_demote = rho * lam
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    sum_size = int(sizes_a.sum())
    n_seed = min(max(sum_size // th, 1), n)

    # Pack state as parallel arrays so every leaf's "best feasible pack" scan
    # is one vector pass (the greedy itself is inherently sequential).  The
    # first-strict-minimum of the scalar scan is np.argmin's first occurrence
    # of the minimum, so the chosen pack is identical to the scalar loop's.
    val = np.zeros(n, np.int64)
    mask = np.zeros(n, np.int64)
    szs = np.zeros(n, np.int64)
    nbits = np.zeros(n, np.int64)
    members: list[list[int]] = []
    seeded = set()
    P = 0
    for i in order[:n_seed]:
        i = int(i)
        val[P] = sids_a[i]
        szs[P] = sizes_a[i]
        members.append([i])
        seeded.add(i)
        P += 1

    big = lam + 1
    for i in range(n):
        if i in seeded:
            continue
        sid, size = int(sids_a[i]), int(sizes_a[i])
        nm = mask[:P] | ((val[:P] ^ sid) & ~mask[:P])
        pc = _popcount_arr(nm)
        feas = (szs[:P] + size <= th) & (pc <= max_demote)
        costs = np.where(feas, pc - nbits[:P], big)
        j = int(np.argmin(costs)) if P else 0
        if P and costs[j] < big:
            mask[j] = nm[j]
            nbits[j] = pc[j]
            szs[j] += size
            members[j].append(i)
        else:
            val[P] = sid
            szs[P] = size
            members.append([i])
            P += 1
    return [Pack(value=int(val[j]), mask=int(mask[j]), size=int(szs[j]),
                 members=members[j]) for j in range(P)]


def pack_isax(parent_sym: np.ndarray, parent_card: np.ndarray,
              csl: tuple[int, ...], pack: Pack, b: int) -> tuple[np.ndarray, np.ndarray]:
    """iSAX word of a pack: parent word refined on the chosen segments whose
    sid bit was *not* demoted (demoted segments keep the parent cardinality —
    exactly the 'demote bits' semantics of §5.4)."""
    sym = parent_sym.astype(np.int64).copy()
    card = parent_card.astype(np.int64).copy()
    lam = len(csl)
    for pos, seg in enumerate(csl):
        bitpos = lam - 1 - pos                       # pos 0 = MSB
        if (pack.mask >> bitpos) & 1:
            continue                                 # demoted → stay coarse
        bit = (pack.value >> bitpos) & 1
        sym[seg] = (sym[seg] << 1) | bit
        card[seg] += 1
    return sym.astype(np.uint16), card.astype(np.uint8)
