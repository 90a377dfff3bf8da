"""Device backend for index construction (port of
``repro.core.build_device``; Coconut-style bottom-up build).

Instead of the host backend's per-row tree recursion, the collection is
reduced to its *distinct SAX words* up front with one device sort, and the
adaptive split (Algorithm 2) then runs over grouped ``(word, multiplicity)``
pairs — the tree is built over at most ``U ≤ N`` word groups, and the final
leaf-contiguous permutation is produced by a single device sort keyed on each
row's leaf atom.  The five build stages (``core/build.py``) map as:

  1. encode       — ``sax_encode_np`` (default, bitwise-identical to the host
                    backend) or the CUDA kernel ``kernels.ops.sax_encode``
  2. group        — :func:`_lexsort_words`: stable sorts of packed SAX
                    words on the device → (permutation, group boundaries,
                    row → word map)
  3. split plan   — ``plan_node_grouped`` (shared with the host layer)
  4. pack         — ``pack_siblings`` (shared with the host backend verbatim)
  5. materialize  — one stable device sort by leaf-atom rank emits the
                    leaf-contiguous order; ``db_ordered`` is a device
                    gather, never round-tripped through the host

The result layout equals the host build's on every dataset where no two
split plans score exactly equal; both drivers expand breadth-first so the
fuzzy replica budget (§6) is consumed in the same node order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import fuzzy as fuzzy_mod
from .build import (BuildStats, DumpyParams, TreeNode, children_isax,
                    collect_leaves, finalize_stats, pack_siblings,
                    partition_by_sid, plan_node_grouped)
from .device_index import resolve_device
from .index import FlatLeaves, flatten_tree
from .lb import node_bounds_np
from .sax import next_bits_np, pack_bits_np, sax_encode_np

ENCODERS = ("np", "kernel")


@dataclasses.dataclass
class DeviceBuildResult:
    """Everything ``DumpyIndex`` needs, plus the device-resident ordered
    collection so ``DeviceIndex`` can be assembled without a host copy."""
    root: TreeNode
    stats: BuildStats
    paa: np.ndarray                 # [N, w] float32
    sax: np.ndarray                 # [N, w] uint8
    flat: FlatLeaves
    order: np.ndarray               # [total] int64 (= flat.order)
    db_ordered_dev: torch.Tensor    # [total, n] float32, on the device


def _stable_lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """The permutation that sorts rows by ``keys`` (the first key primary)
    and then by row id: one stable sort per key, the least significant
    first, starting from the row-id order (``jnp.lexsort`` with the row id
    as its least significant key).  Every row id is distinct, so the
    permutation is the reference's whatever the sort algorithm."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def _lexsort_words(sax: torch.Tensor, w: int, b: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 2: sort rows by SAX word and delimit equal-word groups.

    Packs ``32 // b`` symbols per key column (each column below 2³² in an
    ``int64``), so comparing the columns in order compares the words
    symbol by symbol; equal words keep ascending row order.  Returns
    ``(perm, new_group_flags, row → word index)`` on the device."""
    n = sax.shape[0]
    per = 32 // b
    sax64 = sax.to(torch.int64)
    cols = []
    for c in range(0, w, per):
        key = torch.zeros(n, dtype=torch.int64, device=sax.device)
        for j in range(c, min(c + per, w)):
            key = (key << b) | sax64[:, j]
        cols.append(key)
    perm = _stable_lexsort(cols)
    srt = sax64[perm]
    flags = torch.ones(n, dtype=torch.bool, device=sax.device)
    flags[1:] = (srt[1:] != srt[:-1]).any(dim=1)
    winv = torch.cumsum(flags, 0) - 1
    row2word = torch.empty(n, dtype=torch.int64, device=sax.device)
    row2word[perm] = winv
    return perm, flags, row2word


def _encode(db_dev: torch.Tensor, db: np.ndarray, p: DumpyParams,
            encoder: str) -> tuple[np.ndarray, np.ndarray]:
    """Stage 1 with one of :data:`ENCODERS`: ``(paa [N, w] f32, sax [N, w]
    uint8)`` on the host."""
    if encoder == "np":
        return sax_encode_np(db, p.sax)
    from ..kernels import ops               # "kernel"
    paa_t, sax_t = ops.sax_encode(db_dev, p.sax.w, p.sax.b)
    return (paa_t.cpu().numpy().astype(np.float32, copy=False),
            sax_t.to(torch.uint8).cpu().numpy())


def device_build(db: np.ndarray, params: DumpyParams | None = None, *,
                 encoder: str = "np",
                 device: str | torch.device = "cuda") -> DeviceBuildResult:
    """Bottom-up build over grouped SAX words (Algorithm 1 on ``device``:
    CUDA unless the caller asks for the CPU; raises where CUDA is absent).

    ``encoder`` — ``"np"`` (default; bitwise-identical summaries to the host
    backend, required for exact layout parity) or ``"kernel"`` (the CUDA
    ``sax_encode`` on a CUDA device, its plain twin on the CPU): PAA in
    float32, so a borderline symbol may differ from the host encoder's by
    one breakpoint.
    """
    p = params or DumpyParams()
    device = resolve_device(device)
    if encoder not in ENCODERS:
        raise ValueError(f"unknown encoder: {encoder!r}")
    db = np.ascontiguousarray(db, np.float32)
    n = db.shape[0]
    w, b = p.sax.w, p.sax.b
    p.sax.validate_series_length(db.shape[-1])
    db_dev = torch.from_numpy(db).to(device)

    # -- Stage 1: encode ----------------------------------------------------
    paa, sax = _encode(db_dev, db, p, encoder)

    stats = BuildStats(n_series=n)
    root = TreeNode(np.zeros(w, np.int64), np.zeros(w, np.int64), depth=0)
    root.size = n
    if n <= p.th:                          # trivial collection: root is a leaf
        root.series_ids = np.arange(n, dtype=np.int64)
        finalize_stats(root, stats, p.th)
        flat = flatten_tree(root, b)
        return DeviceBuildResult(root, stats, paa, sax, flat,
                                 flat.order, db_dev)

    # -- Stage 2: group by SAX word ----------------------------------------
    perm_d, flags_d, row2word_d = _lexsort_words(
        torch.from_numpy(np.ascontiguousarray(sax)).to(device), w, b)
    perm = perm_d.cpu().numpy()
    starts = np.flatnonzero(flags_d.cpu().numpy())
    woff = starts.astype(np.int64)                  # word → offset into perm
    wcount = np.diff(np.append(starts, n)).astype(np.int64)
    words = sax[perm[starts]].astype(np.int64)      # [U, w] distinct words
    row2word = row2word_d.cpu().numpy()
    U = len(words)

    rep_budget = np.full(n, p.max_replica, np.int32)
    # per-leaf *atoms*: ordered (word-group selection, extra rows) payloads —
    # the unit the materialization stage lays out contiguously
    leaf_atoms: dict[int, list[tuple[np.ndarray, np.ndarray]]] = {}
    no_rows = np.empty(0, np.int64)

    def split_word_node(node: TreeNode, wsel: np.ndarray, extras: np.ndarray,
                        is_root: bool):
        avail = [j for j in range(w) if node.card[j] < b]
        if not avail:                       # cannot refine → forced leaf
            leaf_atoms[id(node)] = [(wsel, extras)]
            return []

        # -- Stage 3: adaptive split plan over grouped words ---------------
        node_words = words[wsel]
        extra_words = sax[extras].astype(np.int64) if len(extras) else None
        if is_root:
            csl = tuple(range(w)) if len(avail) == w else tuple(avail)
        else:
            if len(extras):
                pw = np.concatenate([node_words, extra_words])
                pc = np.concatenate([wcount[wsel],
                                     np.ones(len(extras), np.int64)])
            else:
                pw, pc = node_words, wcount[wsel]
            csl, nev = plan_node_grouped(pw, pc, node.card, avail,
                                         int(pc.sum()), p.split, b)
            stats.plans_evaluated += nev
        node.csl = csl
        cl = list(csl)

        wsids = pack_bits_np(next_bits_np(node_words[:, cl],
                                          node.card[cl], b))
        wgroups = partition_by_sid(wsids)           # sid → idx into wsel
        if len(extras):
            esids = pack_bits_np(next_bits_np(extra_words[:, cl],
                                              node.card[cl], b))
            egroups = partition_by_sid(esids)
        else:
            esids = no_rows
            egroups = {}
        keys = sorted(set(wgroups) | set(egroups))

        # -- fuzzy duplication (§6): same row order as the host driver -----
        dup_extras: dict[int, list[np.ndarray]] = {}
        if p.fuzzy_f > 0.0:
            lens = wcount[wsel]
            offs = np.cumsum(lens) - lens
            pos = (np.arange(int(lens.sum())) - np.repeat(offs, lens)
                   + np.repeat(woff[wsel], lens))
            naturals = np.sort(perm[pos])
            sids_nat = wsids[np.searchsorted(wsel, row2word[naturals])]
            if len(extras):
                member_rows = np.concatenate([naturals, extras])
                member_sids = np.concatenate([sids_nat, esids])
            else:
                member_rows, member_sids = naturals, sids_nat
            dups = fuzzy_mod.fuzzy_duplicates(
                paa[member_rows], member_sids, node.sym, node.card, csl, b,
                p.fuzzy_f, set(keys), rep_budget, member_rows)
            for tgt, local_idx in dups:
                dup_extras.setdefault(tgt, []).append(member_rows[local_idx])
                stats.n_duplicates += len(local_idx)

        syms, cards = children_isax(node.sym, node.card, csl,
                                    np.asarray(keys, np.int64))
        pending, pending_ids = [], set()
        for k, sid in enumerate(keys):
            g = wgroups.get(sid)
            cw = wsel[g] if g is not None else no_rows
            ce_parts = []
            eg = egroups.get(sid)
            if eg is not None:
                ce_parts.append(extras[eg])
            ce_parts.extend(dup_extras.get(sid, []))
            ce = np.concatenate(ce_parts) if ce_parts else no_rows
            child = TreeNode(syms[k], cards[k], node.depth + 1)
            child.size = int(wcount[cw].sum()) + len(ce)
            node.children[sid] = child
            if child.size > p.th and bool((cards[k] < b).any()):
                pending.append((child, cw, ce, False))
                pending_ids.add(id(child))
            else:
                leaf_atoms[id(child)] = [(cw, ce)]

        # -- Stage 4: pack small siblings (shared with the host) -----------
        for pnode, _, member_children in pack_siblings(node, p, pending_ids):
            atoms: list[tuple[np.ndarray, np.ndarray]] = []
            for c in member_children:
                atoms.extend(leaf_atoms.pop(id(c)))
            leaf_atoms[id(pnode)] = atoms
        return pending

    frontier = [(root, np.arange(U, dtype=np.int64), no_rows, True)]
    while frontier:
        nxt = []
        for nd, wsel, extras, rt in frontier:
            nxt.extend(split_word_node(nd, wsel, extras, rt))
        frontier = nxt

    # -- Stage 5: materialize the leaf-contiguous layout --------------------
    leaves = collect_leaves(root)
    L = len(leaves)
    atom_rank_of_word = np.zeros(U, np.int64)
    atoms_flat: list[tuple[np.ndarray, np.ndarray]] = []
    leaf_sizes = np.zeros(L, np.int64)
    has_extras = False
    for i, leaf in enumerate(leaves):
        leaf.leaf_id = i
        for ws, ex in leaf_atoms[id(leaf)]:
            atom_rank_of_word[ws] = len(atoms_flat)
            atoms_flat.append((ws, ex))
            leaf_sizes[i] += int(wcount[ws].sum()) + len(ex)  # lint: allow-sync: wcount is a host array
            if len(ex):
                has_extras = True

    # natural rows sorted by (leaf-atom rank, row id) on the device
    rank_rows = torch.from_numpy(atom_rank_of_word).to(device)[row2word_d]
    order_nat_d = _stable_lexsort([rank_rows])
    del rank_rows, perm_d, flags_d, row2word_d
    if not has_extras:
        order_dev = order_nat_d
        order = order_dev.cpu().numpy()
    else:
        # splice each atom's extra rows behind its natural block on the host
        # (extras exist only under fuzzy duplication), then re-upload
        order_nat = order_nat_d.cpu().numpy()
        parts = []
        off = 0
        for ws, ex in atoms_flat:
            cnt = int(wcount[ws].sum())  # lint: allow-sync: wcount is a host array
            parts.append(order_nat[off:off + cnt])
            off += cnt
            if len(ex):
                parts.append(ex)
        order = (np.concatenate(parts) if parts else no_rows)
        order_dev = torch.from_numpy(order).to(device)
    db_ordered_dev = db_dev.index_select(0, order_dev)
    del db_dev, order_dev, order_nat_d

    sym = np.zeros((L, w), np.int16)
    card = np.zeros((L, w), np.uint8)
    for i, leaf in enumerate(leaves):
        sym[i] = leaf.sym
        card[i] = leaf.card
    offsets = np.zeros(L + 1, np.int64)
    np.cumsum(leaf_sizes, out=offsets[1:])
    lo, hi = node_bounds_np(sym, card, b)
    flat = FlatLeaves(sym, card, lo, hi, offsets, order)
    for i, leaf in enumerate(leaves):       # tree stays update/save-capable
        leaf.series_ids = order[offsets[i]:offsets[i + 1]].copy()

    finalize_stats(root, stats, p.th)
    return DeviceBuildResult(root, stats, paa, sax, flat, order,
                             db_ordered_dev)
