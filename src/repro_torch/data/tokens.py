"""Deterministic sharded token pipeline (copy of ``repro.data.tokens``).

Synthetic LM data with the three properties the trainer's fault-tolerance
contract needs:

1. **Step-keyed determinism** — ``batch_at(step)`` is a pure function of
   (seed, step), so restart-after-failure replays the identical stream (no
   iterator state beyond the step counter, which lives in the checkpoint).
2. **Host-sharded** — each host materializes only its slice of the global
   batch.  A host is the reference's JAX *process*, which drives every
   device of its machine; here each of those devices has a rank of its
   own, so the ranks of one host (``torchrun``'s ``LOCAL_WORLD_SIZE``) all
   make the host's slice, bitwise the reference's, and each keeps its own
   rows when the batch is placed on the mesh.
3. **Static shapes** — no data-dependent recompiles (straggler hygiene).

The token distribution is a Zipfian unigram mix with a Markov lag-1 blend so
losses have realistic structure (a pure-uniform stream gives a flat loss and
hides optimizer bugs).  The batches are numpy, drawn by the reference's
calls in its order, so they are bitwise the reference's.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch.distributed.sharding import rank_and_size


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


def process_rank_and_count() -> tuple[int, int]:
    """(host index, host count) of this rank, the reference's
    ``(jax.process_index(), jax.process_count())``: ``RANK //
    LOCAL_WORLD_SIZE`` and ``WORLD_SIZE // LOCAL_WORLD_SIZE`` of the
    initialised process group (every rank on one host where the
    environment does not say), or (0, 1)."""
    rank, size = rank_and_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    return rank // local, size // local


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.p = p / p.sum()
        # fixed low-rank Markov structure: next ~ mix(unigram, shift(prev))
        self.shift = rng.integers(0, cfg.vocab, size=cfg.vocab)

    def local_slice(self) -> tuple[int, int]:
        pid, n_proc = process_rank_and_count()
        per = self.cfg.global_batch // n_proc
        return pid * per, per

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        start, per = self.local_slice()
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, start]))
        toks = rng.choice(cfg.vocab, size=(per, cfg.seq_len), p=self.p)
        # blend in lag-1 structure: 30% of positions copy f(prev)
        mask = rng.random((per, cfg.seq_len)) < 0.3
        shifted = self.shift[np.roll(toks, 1, axis=1)]
        toks = np.where(mask, shifted, toks)
        return {"tokens": toks.astype(np.int32)}
