#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # the full run: 4 M x 256 series
    python3 chip_smoke.py --n-series 200000   # a shorter rehearsal
    python3 chip_smoke.py --lm-only        # phases 1, 14 and 15 alone
                                           # (no kernel checks, no ok line)
    python3 chip_smoke.py --dryrun-only    # phases 1 and 16 alone (no
                                           # kernel rows, no ok line)
    python3 chip_smoke.py --train-ranks-only   # phases 1, 15 (c) and 17
                                               # alone (no ok line)
    python3 chip_smoke.py --search-only    # phases 1-13, 16 (b)'s exact
                                           # cells and 18 (no ok line)
    python3 chip_smoke.py --skew-only      # phases 1, 2 and 18 alone (no
                                           # ok line)

Phases, each printed with its seconds:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build: the six CUDA kernels compile from ``src/repro_torch/kernels/csrc``
   into ``build/kernels/`` (one ``nvcc`` per source, in parallel), with
   ``ptxas``'s registers and shared memory for ``pairwise_l2``;
3. data and index: the paper's *Rand* collection (``random_walks``), the
   host build with the paper's defaults (w=16, b=8, th=10 000), the upload
   of the leaf-aligned ``DeviceIndex`` (chunk 2048, one shard);
4. kernels: the launch floor (the device time of a one-element ``add_``);
   every kernel against its plain PyTorch twin on the card, at the
   main paths' shapes (taken from this index and these queries) and at
   ragged ones, with the stated tolerances (``sax_encode`` and
   ``lb_paa_interval`` also bitwise against their in-order sums, at their
   edges, unaligned, at other positions and at scale: the whole resident
   shard, and 256 queries against the shard-0 leaf table repeated 25
   times; ``dtw_band`` bitwise, also on
   a band past the shared-memory frontier's cap; ``pairwise_l2`` and
   ``lb_keogh`` also at their edges, unaligned operands and a row of 60 000
   included, and bitwise equal for the same pair at other positions, in a
   second call and, for ``lb_keogh``, in the per-query layout); each
   kernel's time next to its bound, its twin's time and, where one PyTorch
   call computes the same function, that call's time (``lb_keogh`` also
   beside its issue bound, and at the sub-slab and gathered chunk);
5. ED main path: 256 held-out queries in 4 batches of 64 through
   ``exact_search_device_batch`` (k=10), every result held against a
   float64 brute force on the card, one batch rerun with ``n_shards=4``
   (bitwise equal), and the launch count of each kernel on this phase;
6. profile: one more ED batch under ``torch.profiler``, its CUDA
   activity alone (device time by kernel, and by name for each of the six
   kernels, the device's busy share of the batch);
7. DTW main path: 128 held-out queries in 2 batches of 64 through
   ``exact_search_device_batch(metric="dtw")`` (k=10, band 25 = 10% of the
   length, order "cluster") on the same ``DeviceIndex`` (no second layout
   is built), batch 0's results held against an independent float64
   check on the card (LB_Keogh over every live row, LB_Improved, then a
   banded DP over the rows they cannot rule out), batch 0 rerun with
   ``order="perq"`` and ``n_shards=4`` and its first 16 queries with
   ``order="shared"`` (each bitwise equal), the cascade counters and the launch count of each kernel on
   this phase; then
   ``dtw_band`` at the lane walk's real calls (one "cluster" group of 16
   queries x 128 lanes, with the walk's mask and cutoff, recorded from a
   rerun of batch 0): bitwise against its twin, its time, and its bound
   from the cells each lane ran before it was abandoned;
8. DTW profile: one more DTW batch under ``torch.profiler``, its CUDA
   activity alone (kernel rows, no operator rows: the profiler takes
   longer to read a DTW batch's trace than to record it, less than half
   as long without the host's events);
9. approximate and extended search (paper Alg. 4) on the same
   ``DeviceIndex`` and queries (no second layout): ED
   ``approximate_search_device_batch`` at nbr 1, 4, 16 and ED
   ``extended_search_device_batch`` at nbr 1, 4, 16 with ``rerank`` True
   and False (4 batches of 64), DTW extended (band 25, ``rerank=True``) at
   nbr 1, 4, 16 (2 batches of 64).  Checks, each failing the run: ED
   extended with re-rank bitwise equal to the host ``extended_search`` for
   every query of batch 0; approximate nbr=1 leaves equal to the host
   ``route_to_leaf`` for all 256 queries; every result of every path equal
   to a float64 top-10 over its query's scheduled leaves (ED: brute force;
   DTW: LB_Keogh then the banded DP, all 128 queries); recall and every
   query's k-th distance monotone in nbr; extended with ``n_shards=4``
   bitwise equal to one shard (ED, DTW).  Prints queries/s (the median of
   passes over each configuration's batches, repeated for at least 1 s,
   with the slowest and fastest pass), recall@10 against phases 5 and 7, launches of each kernel a batch and
   ``max_memory_allocated`` for each configuration; ``lb_paa_interval`` on
   the routing edge table and ``lb_keogh``, ``lb_improved`` and
   ``dtw_band`` at two real per-query leaf ranks, each against its twin and
   timed beside its bound and the launch floor; one profiled ED and one DTW
   extended batch at nbr=16;
10. serving on the same ``DeviceIndex`` (no second layout; ``k_max`` 10,
   ``nbr_max`` 4, band 25): (a) a bucket of every ladder size 1–64 (k
   cycling 1..10, nbr 1..4, every fourth lane DTW, one dead lane), each
   live lane held against the same request alone through
   ``extended_search_device_batch(rerank=False)`` and against a float64
   top-k over its scheduled leaves; (b) the five kernels a bucket launches
   (``pairwise_l2`` is off this path) at B = 1 and B = 64 against their
   plain versions, timed beside their bounds, with their launches a
   bucket; (c) ``bucket_search_launch`` under
   ``torch.cuda.set_sync_debug_mode("error")`` with the stream held: it
   returns before the device starts, host µs against the bucket's device
   ms; (d) open-loop Poisson load through ``CoalescingFrontend``
   (``max_batch`` 64, ``max_wait`` 2 ms, the knob mix of
   ``benchmarks/bench_serving.py``) at 0.25, 0.6, 1.0 and 1.4 x phase 9's
   closed-loop ED extended nbr=4 ``rerank=False`` rate, then a 25%-DTW mix
   at half the closed-loop rate of such buckets, after a NaN request that
   must fail only its own future; queries/s, latency p50 / p99 / p99.9
   from the scheduled arrival, occupancy and padding; (e) the kNN-softmax
   head at OLMo-1B's width (``lm_head [2048, 50 304]`` from the seed): the
   front-end's tokens equal ``step_batch``'s, the batched candidates equal
   the host search's up to ties, decode tokens/s and recall;
11. the index lifecycle on the same collection: (a) the device build
   (``backend="device"``, ``sax_encode_np``) bitwise equal to phase 3's
   host build (leaf layout, routing arrays, stats), its ``DeviceIndex``
   assembled from the rows on the card bitwise phase 3's, seconds beside
   the host build's; (b) the device build with the ``sax_encode`` kernel:
   the kernel's ms over the collection beside its bound, the symbols that
   differ from ``sax_encode_np``, every row inside its leaf's SAX region,
   one exact ED batch against the float64 brute force, the layout equal
   to (a)'s where no symbol differs; (c) ``save`` and ``load`` (seconds,
   GB, sha256 checks included) of the first 1 M series under a temporary
   directory in ``build/``, then one exact ED batch on the loaded index
   bitwise equal to the same batch before the save; (d) 1 000 inserts
   through the write-ahead log, a save crashed at ``index.save.commit``, a
   load that replays the log: the pre-crash ``db`` and ``alive``, 8
   inserted series found at distance 0; (e)
   ``repro_torch.robustness.smoke`` on the card;
12. distributed build and search, and the baseline indexes, on the same
   collection: (a) ``build_distributed`` on the mesh ``[cuda:0]``: its
   table bitwise ``sax_encode`` over the same rows, each symbol that
   differs from ``sax_encode_np`` borderline as in 11 (b), every row in
   its leaf, the leaf count of 11 (b)'s kernel-encoder build; four row
   shards (``encode_distributed``, on ``[cuda:0] x 4`` and, with two
   or more cards, over every card) give the same table and a histogram
   summing to N that equals the host bincount of the next-bit codes;
   seconds beside phase 11's builds; (b) ``search_distributed``: batch 0
   of exact ED on ``[cuda:0]`` bitwise phase 5's; on ``[cuda:0] x 4``
   (four shards through the per-device code, their loops driven at once)
   exact ED, extended ED nbr=4 with re-rank, approximate nbr=4 on the
   placed ``DeviceIndex`` and one DTW batch bitwise phases 5, 9 and 7's;
   shard 3 dead: the coverage equals ``shard_coverage`` and the answers a
   float64 top-k over the live shards' rows; with two or more cards, the
   same five paths on four shards over every card (``cuda:s % cards``),
   each bitwise the ``[cuda:0] x 4`` answer, else "across cards: not run
   (1 card)"; every timer waits for every card of its mesh; the launches
   of every kernel on (b); (c)
   ``search_step`` over the whole collection ``[64, N, 256]``: one
   ``pairwise_l2`` and one ``lb_paa_interval`` launch, the ids phase 5's
   up to ties and the distances within rtol 1e-5 of phase 5's, each d²
   also within 1e-5·(|q|² + |x|²) of its float64 value (ids swapped only
   inside that rounding), ``sqrt(lbs) <= d[:, 0]``; ``pairwise_l2``
   at that shape against its twin on three column slices and bitwise a
   call over each slice alone, timed beside its bound, its twin and
   ``torch.cdist(q, x).square()``; (d) Dumpy, iSAX2+ and TARDIS over the
   first 250 000 series (w=16, b=8, th=10 000): host build seconds, leaves,
   height, fill factor, ``DeviceIndex`` set-up, exact ED batch 0 against a
   float64 brute force over those series with its launches, recall@10 of
   extended search at nbr 1, 4, 16 against it, and ``lb_paa_interval`` at
   each structure's leaf and routing edge tables (bitwise the in-order
   sum, timed beside its bound and twin).  The ``kernels`` line gives
   each kernel's rows at these new shapes under ``new_shapes``;
13. the analysis gates (``repro_torch.analysis``): (a) the lint over
   ``src/repro_torch`` and this script, 0 findings, its suppressions
   counted; (b) every registered entry at the audit shapes under a census
   on the card, against the CPU golden ``contracts_torch.json``: no
   float64 on a device path, no host sync in a sync-free entry, and for
   the ``shape_fixed`` entries the golden's kernel calls and host syncs
   exactly; every kernel call the census counts is a launch (all six
   kernels run); (c) the steady-state sweep on the card (the k/nbr/metric/
   batch grid and the bucket ladder twice: nothing built on the warm pass,
   every call's kernel calls, aten ops and syncs repeated, one launch
   sequence per bucket shape, no sync in a bucket launch); (d) a census of
   one batch of each main-path entry on phase 3's ``DeviceIndex`` (not
   rebuilt): exact ED, exact DTW ``cluster``, approximate nbr 4, extended
   nbr 4 (ED with re-rank, DTW) and a 64-lane mixed bucket — kernel calls,
   eager aten ops, host syncs and peak bytes (over the resident index) of
   each, each answer bitwise the earlier phase's, exact ED's syncs equal
   to its reported ``host_syncs`` plus the query upload and three result
   downloads, no sync inside the bucket launch.  No timing is taken under
   a census;
14. the LM substrate (``repro_torch.models``; it reaches none of the six
   kernels): (a) each of the ten architectures at ``reduced(...)`` in
   float32 (TF32 asserted off), parameters from ``--seed`` on the host:
   ``forward_train`` + ``loss_fn``, ``forward_prefill`` of S-1 tokens and
   one ``forward_decode`` at B=2, S=32 on the card against the same on the
   CPU (logits, loss, every cache leaf: atol = rtol = 1e-3; the recurrent
   xlstm and recurrentgemma, whose reduced models amplify rounding, within
   10% of each array's magnitude, and each of their blocks run alone on
   the CPU's inputs within 1e-3 of its outputs' magnitude), decode at S-1
   against ``forward_train`` (the reference test's 2e-2 prefill, 7e-2 /
   5e-2 decode), gradients of ``loss_fn`` finite and nonzero; (b) OLMo-1B
   at full width (16 x 2048, 16 x 128 heads, d_ff 8192, vocab 50 304,
   float32 parameters made on the card, bfloat16 compute): prefill of
   4 x 2048 tokens, 64 decode steps from that cache pre-sized to 2112,
   ``forward_train`` + loss at 4 x 2048, each timed beside its bound
   (prefill and train: model FLOPs over the dense bf16 peak; a decode
   step: the parameter and cache bytes it must read over the HBM rate);
   decode logits at 8 positions against ``forward_train``'s (argmax
   agreement >= 7/8, max |d| over the logits' RMS within 2e-2 or twice
   the same positions' bf16-vs-float32 gap of ``forward_train``), the
   bf16 model against float32 compute on B=1, S=256, every value finite,
   peak memory;
15. the LM entry points (``repro_torch.launch``, ``repro_torch.train``;
   the kNN-softmax head reaches ``sax_encode`` and ``lb_paa_interval``
   through the coalescing front-end at every decode step): (a)
   ``serve.generate`` on olmo-1b's smoke preset (float32, TF32 off), seed-0
   parameters made on the CPU and moved, B 4, prompt 32, 32 tokens: plain
   tokens on the card equal the CPU's; with the head (th 64, 64
   candidates, nbr 8) ``step_batch_via == step_batch`` at each card step
   and the tokens equal the CPU's (a differing token passes only where the
   two candidate sets differ by ties at rtol 1e-5, and is printed); (b)
   OLMo-1B at full width through ``generate`` with ``serve.main``'s
   defaults, without and with the head: prefill seconds, decode tokens/s
   and median ms a step beside the step's bound (the float32 weights but
   the embedding, and the cache, read once), every logit finite, the
   head's build seconds, kernel launches a decode step (the wrappers'
   counts) and device ms a step (profiled), its stats and the front-end's;
   (c) ``launch.train``'s ``100m`` preset of olmo-1b (float32, TF32 off)
   as its ``main`` trains it, 20 steps of 8 x 512 with checkpoints every
   10 under ``build/``, under ``torch.use_deterministic_algorithms(True)``:
   steps/s and tokens/s beside the bound (model FLOPs over the float32 67
   TFLOP/s), peak memory, the last 4 losses below the first 4 by more
   than 0.05; the resume (10 steps, a blocking checkpoint, a new
   ``Trainer`` to 20) bitwise that run (within atol 1e-5 with default
   algorithms, the op printed, if one refuses determinism); a
   checkpoint's save and restore (seconds, bytes, bitwise); a profile of
   one step; (d) OLMo-1B at full width
   (``remat="full"``), train steps of 4 x 2048: ms a step beside the bound
   (model FLOPs over the bf16 989 TFLOP/s), peak memory beside the
   parameters, gradients and moments alone, loss and grad norm finite, a
   profile of one step by kernel name;
16. the dry run (``repro_torch.launch.dryrun``: fake tensors, DTensor
   placement, per-device op cost, the H100 roofline; it reaches the six
   kernels through their ``abstract`` functions): (a) in a child process,
   OLMo-1B's train_4k and decode_32k and the Dumpy cells build, search,
   search_sharded, search_dtw, search_approx, search_extended,
   search_bucket and serving on the 16 x 16 production mesh (a fake
   process group of 256 ranks): no record has an error or a skip; each
   one's bottleneck, step bound, GiB a device and the trip counts of the
   loops it counts by trip (the exact cells' spans); (b)
   on a 1 x 1 mesh against the card: the ``100m`` train step at 8 x 512
   and OLMo-1B's decode step at B 4 over a 64-position cache, the dry
   run's FLOPs equal to ``FlopCounterMode`` over the real step, its peak
   beside ``max_memory_allocated`` over the step, the measured step no
   faster than the dry run's bound; the ``search`` cell at
   ``[64, N, 256]``, its ``pairwise_l2`` term within 1% of phase 12 (c)'s
   bound and no more than its time; the exact ED and DTW ``cluster``
   searches at batch 64 counted over fake copies of the resident layout
   (run right after phase 13, which phase 14 frees): ED's ``pairwise_l2``
   and ``lb_paa_interval`` calls equal to phase 13 (d)'s census of a real
   batch (every span runs there), DTW's three kernels at least the
   census's (its walk stops early, the count does not), one real batch
   each timed, ED's no faster than its bound (DTW's bound, every walk
   chunk, is the worst case and no floor: printed, not gated), DTW's
   predicted peak beside ``max_memory_allocated``; (c) each kernel's
   ``abstract`` work at its main shape (``dtw_band``: the wide path, every
   lane on) within 1% of this run's bound there, the time measured there
   no less.
17. training over ranks: ``repro_torch.launch.train.main`` under
   ``torchrun`` (NCCL, one rank on ``cuda:0``: the process group, the
   device from ``LOCAL_RANK``, the placed model on the ``(1, 1)`` mesh,
   rank 0's checkpoints, the stop flag agreed by an all-reduce), each
   rank a child process of this script (``train-rank``): (a) the ``100m``
   preset, 20 steps of 8 x 512 with a checkpoint every 10, stopped by a
   SIGTERM while step 9's data is drawn (it saves step 10), then rerun to
   20, resuming there: the 20 losses against phase 15 (c)'s within rtol
   1e-4 (the same kernels on a (1, 1) mesh: bitwise expected, and
   printed), the median step beside 15 (c)'s; (b) OLMo-1B at its
   published width (``--preset full``), 2 steps of 4 x 2048 without a
   checkpoint, each step's ms beside 15 (d)'s plain steps and their bound.
   Two ranks on the one card are not run: NCCL refuses two ranks on one
   device and gloo's CUDA collectives crash there
   (``scripts/probe_two_ranks_one_card.py``, ``PERF.md``).  (c), where four
   cards or more are visible (else one line says so and nothing runs):
   ``scripts/train_over_cards.py`` on the ``smoke`` preset (float32), 2
   steps of 8 x 128 on a ``(2, 2)`` mesh from two ``torchrun`` launchers
   that act as two hosts of two cards, against one card drawing the same
   rows: the first loss within 1e-5, every first-step gradient leaf within
   1e-4 by both of the script's measures, the same step in float64 within
   1e-12 and 1e-8, each rank's rows, each host's tokens bitwise; the step
   ms beside one card's.
18. the skewed collection and Dumpy-Fuzzy (run in the search slice, after
   16 (b)'s exact cells; ``--skew-only`` runs phases 1, 2 and 18 alone):
   (a) ``clustered_series`` at the run's size x 256, 64 clusters, seed 1
   (the reference benchmark's ``skew``), its seconds, peak host bytes and
   cluster shares; (b) Dumpy-Fuzzy (``fuzzy_f`` 0.1, ``max_replica`` 3)
   built on the host, in a forked process, and with ``backend="device"``
   beside it, the SHA-256 of their tree JSON, leaf layout, routing arrays
   and stats equal; plain Dumpy built on the host; each layout's leaves,
   height, nodes, fill factor, leaf sizes, ``lmax`` and bytes on the card;
   (c) exact ED (128 queries) and DTW (32, band 25, ``cluster``; 16 where
   four cards or more are visible, which phase 17 (c) uses) on both
   layouts, held against float64 checks over the collection itself, no
   repeated id, the two layouts equal up to ties; (d) approximate and
   extended ED at nbr 1, 4, 16 and extended DTW at nbr 4 on both layouts,
   recall@10 of each; on Dumpy-Fuzzy approximate nbr=1 on the host
   ``route_to_leaf``'s leaf and equal to the host ``approximate_search``
   up to ties, extended ED bitwise the host ``extended_search``, every
   configuration equal to the float64 top-10 over its scheduled leaves,
   each id once; (e) a 64-lane bucket (25% DTW, a dead lane) on
   Dumpy-Fuzzy lane by lane against lone requests; (f) 1 000 ids deleted
   (replicated ones first): every replica dead in the ``DeviceIndex``, an
   exact ED batch free of them and equal to the float64 brute force over
   the live rows; (g) each kernel's launches in the phase (none may be 0),
   ``lb_paa_interval`` at Dumpy-Fuzzy's leaf table and routing edges
   against its in-order sum and timed.  Its layouts are freed before
   phase 14.
"""
from __future__ import annotations

import argparse
import gc
import json
import multiprocessing
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (dense): HBM bytes/s and float32 outside the
# tensor cores; the card's power limit is printed beside every time
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

K = 10
BATCH = 64
N_QUERIES = 256
LENGTH = 256
CHUNK = 2048
N_DTW = 128            # DTW queries: 2 batches of 64
NBRS = (1, 4, 16)      # leaf budgets of the approximate and extended paths
QPS_WINDOW_S = 1.0     # phase 9 times each configuration over at least
QPS_MIN_PASSES = 3     # this many seconds and passes over its batches
BAND = 25              # default_band(256): the paper's 10% Sakoe-Chiba band
# DTW cascade cost model for the bounds: float32 operations per element of
# LB_Keogh (2 sub, 3 max, mul, add) and LB_Improved (LB_Keogh, the clip,
# van Herk max/min, the second pass) and per cell of the band DP
LBK_OPS, LBI_OPS, DTW_CELL_OPS = 7, 20, 5
# the floor of one step of the DP's chain of 2n-1 dependent anti-diagonals:
# a dependent min and add, 4 cycles of f32 latency each
CHAIN_STEP_CYCLES = 8
# the float64 DTW check drops the pairs past its bound every this many
# anti-diagonals of the DP
DTW_ABANDON_EVERY = 16
# the float64 ED brute force keeps this many candidates past k + 1 from
# its |q|² + |x|² - 2 q·x pass before their direct differences
BRUTE_SLACK = 8
# phase 7 holds dtw_band at this many of the walk's recorded calls
WALK_SAMPLE = 16
# phase 7's rerun with order="shared" (the slowest order) takes batch 0's
# first this many queries
DTW_SHARED_QUERIES = 16
DTW_WIDE = (2, 5, 2600, 2500)   # (Q, m, n, r): a band no shared frontier holds
# the operations the lb_improved kernel itself does per element (its source
# note: d = v - clip(v, lo, hi) in place of two gaps, an FMA counting two)
LBI_KERNEL_OPS = 16
# the instructions the lb_keogh kernel issues per element (its source note:
# two FADD, two FMNMX, one FFMA), at 128 lanes a clock on each SM
LBK_KERNEL_INSTR, LANES_PER_SM = 5, 128
# lb_keogh's edges (Q, m, n), each in both layouts, aligned and one float
# off 16-byte alignment: ragged tiles, a length not a multiple of 4, many
# turns of the ring, and a row longer than a block's shared memory holds
LBK_EDGES = [(33, 31, 97), (65, 97, 2600), (1, 3, 60000)]
KERNELS = ("sax_encode", "pairwise_l2", "lb_paa_interval", "lb_keogh",
           "lb_improved", "dtw_band")
# pairwise_l2's edges (Q, X, n), each also with operands whose data_ptr is
# not 16-byte aligned: lengths not a multiple of 4 (the 4-byte copy
# instance), the search's 256, a row long enough for many turns of the ring
L2_EDGES = [(Q, X, n) for n in (1, 3, 97, 256, 2600)
            for Q, X in ((1, 1), (17, 333), (64, 2048), (65, 31), (130, 333))]
# sax_encode's edges (B, n, w, b), each also one float off alignment: a
# length not a multiple of 4 (segments of 341), segments not a multiple
# of 4, 100 000 rows of the collection's width, one row, b = 1, and
# segments of 15 000 floats (streamed through many staged chunks)
SAX_EDGES = [(7, 1023, 3, 4), (300, 96, 12, 8), (100_000, 256, 16, 8),
             (1, 256, 16, 1), (3, 60_000, 4, 8)]
# lb_paa_interval's edges (Q, L, w), each also one float off alignment:
# the generic instance's widths (1, 3, 17, 33, 64; w = 64 past the first
# kernel's 32), ragged query and leaf tiles, the compiled widths 8 and 16
LBPAA_EDGES = [(1, 1, 1), (5, 333, 3), (9, 77, 64), (33, 1500, 33),
               (64, 757, 17), (130, 1500, 8), (3, 700, 16)]
# the leaf table at scale: the shard-0 table repeated, 757 x 25 = 18 925
# leaves, as a 100 M-series collection at th = 10 000 has
LB_SCALE = 25
# phase 12 (d): the structure comparison runs on the first 250 000 series
# (the iSAX2+ host build grows faster than linearly in the collection)
BASELINE_ROWS = 250_000
# phase 11 (c), (d): save, load, the crashed save and its recovery run on
# the first 1 M series (a 1.12 GB store)
SAVE_ROWS = 1_000_000
# phase 10, serving: the knob bounds, coalescing settings and rates of
# benchmarks/bench_serving.py
SERVE_K_MAX, SERVE_NBR_MAX = 10, 4
SERVE_MAX_BATCH, SERVE_MAX_WAIT = 64, 0.002
SERVE_LADDER = (1, 2, 4, 8, 16, 32, 64)
KNOB_MIX = ((5, 1), (10, 4), (10, 2), (5, 4), (10, 1), (5, 2))
RATE_FRACS = (0.25, 0.6, 1.0, 1.4)   # of the closed-loop batch-64 rate
DTW_MIX_FRAC = 0.5                   # of the closed-loop 25%-DTW rate
LOAD_S = 1.0                         # each rate's arrival schedule spans this
# phase 11: the routing arrays a device build must match
# (tests/test_build_pipeline.py)
ROUTING_FIELDS = ("node_csl", "node_shift", "node_lam", "edge_parent",
                  "edge_sid", "edge_leaf", "edge_child", "edge_nl",
                  "edge_begin", "edge_end", "node_begin", "node_end",
                  "leaf_parent", "grp_off", "grp_begin", "grp_end")
SERVING_KERNELS = ("sax_encode", "lb_paa_interval", "lb_keogh",
                   "lb_improved", "dtw_band")
# the kNN-softmax head at OLMo-1B's published width
# (src/repro/configs/olmo_1b.py: d_model 2048, vocab 50 304)
OLMO_D, OLMO_VOCAB = 2048, 50_304
# phase 13 (d): the leaf budget of the approximate, extended and bucket
# censuses
CENSUS_NBR = 4
# phase 14: the dense bf16 peak of the card (the prefill and train bound);
# (a)'s batch and length (tests/test_models.py's) and card-vs-CPU tolerance
BF16_OPS_PER_S = 989e12
LM_B, LM_S, LM_TOL = 2, 32, 1e-3
# the recurrent reduced models amplify float32 order differences through
# their std-1 weights (the CPU tests: the reference's xlstm moves 7.4e-3
# when its embedding is scaled by one ulp; RG-LRU's sqrt(1 - a²) at
# a ≈ 0.999 turns an ulp of a into ~6e-5 of b), so their whole-model
# arrays are held to 10% of their magnitude and each block, run alone on
# the CPU run's own inputs, to LM_BLOCK_TOL of its outputs' magnitude
LM_BLOCKWISE = ("xlstm-1.3b", "recurrentgemma-9b")
LM_WHOLE_TOL, LM_BLOCK_TOL = 0.1, 1e-3
# (b): OLMo-1B's prefill batch and length, decode steps, positions checked
# against forward_train, and the bf16-vs-float32 comparison's shape
OLMO_B, OLMO_S, OLMO_STEPS, OLMO_CHECKS = 4, 2048, 64, 8
OLMO_F32_B, OLMO_F32_S = 1, 256
# phase 15: launch/serve.py's defaults (batch, prompt, tokens) and its
# kNN-softmax head; launch/train.py's 100m preset at its docstring's batch
# and length, with a checkpoint half way; one full-width OLMo-1B train step
SERVE_B, SERVE_P, SERVE_T = 4, 32, 32
SERVE_HEAD = dict(th=64, r_candidates=64, nbr_nodes=8)
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT = 8, 512, 20, 10
FULL_B, FULL_S, FULL_STEPS = 4, 2048, 3
# phase 17: OLMo-1B's full-width steps on one NCCL rank, and each
# torchrun launch's time limit
RANK_FULL_STEPS, RANK_TIMEOUT_S = 2, 240
# ... and (c), the smoke preset on (2, 2) from two launchers (four cards)
HOSTS_B, HOSTS_S, HOSTS_STEPS = 8, 128, 2
# phase 16: the dry run's production cells (16 x 16), their time limit,
# the steps timed against the 1 x 1 bounds, and PERF.md's hand bound of
# OLMo-1B's decode step (the float32 weights read once)
DRYRUN_SHAPES = ("train_4k", "decode_32k")
DRYRUN_KINDS = ("build", "search", "search_sharded", "search_dtw",
                "search_approx", "search_extended", "search_bucket",
                "serving")
# ... and two cells of the recurrent architectures, counted by a second
# child at once: xLSTM's loops by trip, Griffin's scan
DRYRUN_CELLS = ("xlstm-1.3b:train_4k", "recurrentgemma-9b:prefill_32k")
DRYRUN_TIMEOUT_S, DRYRUN_STEPS = 300, 3
OLMO_DECODE_HAND_BOUND_MS = 1.413
# phase 18: the reference benchmark's skewed collection and its Dumpy-Fuzzy
# (benchmarks/common.py: clustered_series(n, length, n_clusters=64, seed=1),
# "dumpy-fuzzy" at fuzzy_f 0.1), max_replica 3; 128 ED queries (the first
# 32 of them for DTW and the extended DTW path at nbr 4), 1 000 tombstones
SKEW_CLUSTERS, SKEW_SEED = 64, 1
SKEW_FUZZY_F, SKEW_MAX_REPLICA = 0.1, 3
SKEW_ED_QUERIES, SKEW_DTW_NBR, SKEW_TOMBSTONES = 128, 4, 1000
SKEW_DTW_QUERIES = 32
SKEW_CHILD_TIMEOUT_S = 400     # the forked host build's limit


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's top SM clock (``nvidia-smi``), for the DP's chain
    floor."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, args_list, warmup: int = 3) -> tuple[float, float]:
    """``(device ms, host ms)`` per call over ``args_list`` (one call per
    entry), after ``warmup`` calls.  The stream is held by a ~0.1 s
    ``torch.cuda._sleep`` while the host queues every call, so the CUDA
    events around the calls time the device's work alone, not the host's
    launch overhead; the host's wall time to queue one call is the second
    number."""
    for a in args_list[:warmup]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    t0 = time.perf_counter()
    for a in args_list:
        fn(*a)
    host = (time.perf_counter() - t0) * 1e3 / len(args_list)
    end.record()
    torch.cuda.synchronize()
    if host * len(args_list) > 50.0:
        fail(f"queueing {len(args_list)} calls took {host * len(args_list)}"
             f" ms, longer than the stream was held: device time unclear")
    return start.elapsed_time(end) / len(args_list), host


def unaligned(torch, t):
    """A copy of ``t`` one float into a buffer: its ``data_ptr`` is not
    16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = buf[1:].view(t.shape)
    v.copy_(t)
    return v


def ptxas_report(log: str, source: str) -> list[str]:
    """``ptxas -v``'s lines for each kernel instance of ``source`` in the
    build log: the instance's mangled name, then its registers and static
    shared memory."""
    head = f"== {source}\n"
    if head not in log:
        return []
    sec = log.split(head, 1)[1].split("\n== ", 1)[0]
    lines, name = [], "?"
    for line in sec.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif "Used" in line and "registers" in line:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}")
    return lines


def check_pairwise_l2_edges(torch, ops, ref, qs_main, db0, gen) -> float:
    """``pairwise_l2`` at ``L2_EDGES`` in both layouts against its twin, then
    the same pair at other positions bitwise: the main slab's query rows
    rotated, the slab taken 37 rows earlier, unaligned copies of both
    operands (the 4-byte copy instance), and a second call.  Fails the run
    on a miss; returns the largest |err| of the edges."""
    err, worst = 0.0, 0.0
    for Q, X, n in L2_EDGES:
        for layout in ("aligned", "offset"):
            q = torch.randn(Q, n, generator=gen, device="cuda")
            x = torch.randn(X, n, generator=gen, device="cuda")
            if layout == "offset":
                q, x = unaligned(torch, q), unaligned(torch, x)
            got = ops.pairwise_l2(q, x)
            want = ref.pairwise_l2_ref(q, x)
            torch.cuda.synchronize()
            scale = (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
            rel = float(((got - want).abs() / scale).max())
            if (torch.isnan(got).any()
                    or not bool(((got - want).abs() <= 1e-5 * scale).all())):
                fail(f"pairwise_l2 disagrees with its twin at edge "
                     f"[{Q},{X},{n}] {layout}: max rel {rel:.3e}")
            err = max(err, float((got - want).abs().max()))
            worst = max(worst, rel)
    print(f"  pairwise_l2 edges: {2 * len(L2_EDGES)} cases (Q in 1..130, X "
          f"in 1..2048, n in 1, 3, 97, 256, 2600, aligned and offset) "
          f"within 1e-5 (|q|^2 + |x|^2) of the twin; max |err| {err:.3e}, "
          f"max rel {worst:.3e}")
    s0 = 5 * CHUNK
    base = ops.pairwise_l2(qs_main, db0[s0:s0 + CHUNK])
    checks = {
        "second call": (ops.pairwise_l2(qs_main, db0[s0:s0 + CHUNK]),
                        base),
        "query rows rotated by 5": (
            ops.pairwise_l2(torch.roll(qs_main, 5, 0),
                            db0[s0:s0 + CHUNK]),
            torch.roll(base, 5, 0)),
        "slab 37 rows earlier": (
            ops.pairwise_l2(qs_main, db0[s0 - 37:s0 - 37 + CHUNK])[:, 37:],
            base[:, :CHUNK - 37]),
        "unaligned operands": (
            ops.pairwise_l2(unaligned(torch, qs_main),
                            unaligned(torch, db0[s0:s0 + CHUNK])), base)}
    torch.cuda.synchronize()
    for what, (got, want) in checks.items():
        if not torch.equal(got, want):
            fail(f"pairwise_l2 is not position-invariant: {what} changes "
                 f"{int((got != want).sum())} values")
    print(f"  pairwise_l2 [64,2048,256] bitwise equal across: "
          f"{', '.join(checks)}")
    return err


def check_lb_keogh_edges(torch, ops, ref, envelope, db0, U, L, idx,
                         gathered, gen) -> float:
    """``lb_keogh`` at ``LBK_EDGES`` in both layouts and alignments within
    rtol 1e-5 of its twin, then the main slab's values bitwise at other
    positions: the query rows rotated, the slab 37 rows later, unaligned
    copies of the operands (the 4-byte copy instance), a second call, and
    the lane walk's gathered [64, 128, 256] chunk (the per-query layout)
    against the same pairs of the shared slab.  Fails the run on a miss;
    returns the largest |err| of the edges."""
    err = 0.0
    for Q, m, n in LBK_EDGES:
        qs = torch.randn(Q, n, generator=gen, device="cuda").cumsum(1)
        eU, eL = (t.clone() for t in envelope(qs, max(n // 10, 1)))
        eU[:, [0, -1]], eL[:, [0, -1]] = float("inf"), -float("inf")
        for layout in ("shared", "gather"):
            shape = (m, n) if layout == "shared" else (Q, m, n)
            x = torch.randn(*shape, generator=gen, device="cuda").cumsum(-1)
            for a in ((x, eU, eL),
                      tuple(unaligned(torch, t) for t in (x, eU, eL))):
                got, want = ops.lb_keogh(*a), ref.lb_keogh_ref(*a)
                torch.cuda.synchronize()
                if torch.isnan(got).any():
                    fail(f"lb_keogh produced NaN at edge [{Q},{m},{n}] "
                         f"{layout}")
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
                err = max(err, float((got - want).abs().max()))
    print(f"  lb_keogh edges: {4 * len(LBK_EDGES)} cases ([Q, m, n] in "
          f"{LBK_EDGES}, shared and per query, aligned and offset) within "
          f"rtol 1e-5 of the twin; max |err| {err:.3e}")
    slab = db0[:CHUNK]
    base = ops.lb_keogh(slab, U, L)
    checks = {
        "second call": (ops.lb_keogh(slab, U, L), base),
        "query rows rotated by 5": (
            ops.lb_keogh(slab, torch.roll(U, 5, 0), torch.roll(L, 5, 0)),
            torch.roll(base, 5, 0)),
        "slab 37 rows later": (
            ops.lb_keogh(db0[37:37 + CHUNK], U, L)[:, :CHUNK - 37],
            base[:, 37:]),
        "unaligned operands": (
            ops.lb_keogh(*(unaligned(torch, t) for t in (slab, U, L))),
            base),
        "gathered [64,128,256] chunk (per query)": (
            ops.lb_keogh(gathered, U, L), torch.gather(base, 1, idx))}
    torch.cuda.synchronize()
    for what, (got, want) in checks.items():
        if not torch.equal(got, want):
            fail(f"lb_keogh is not position-invariant: {what} changes "
                 f"{int((got != want).sum())} values")
    print(f"  lb_keogh [64,2048,256] bitwise equal across: "
          f"{', '.join(checks)}")
    return err


def launch_floor(torch, n_iter: int) -> float:
    """The launch floor: device ms of the smallest launch (a one-element
    in-place ``add_``) under the timer every kernel is timed with."""
    one = torch.zeros(1, device="cuda")
    ms, _ = time_ms(torch, lambda t: t.add_(1.0), [(one,)] * n_iter)
    return ms


def sax_bitwise(torch, ops, ref, x, w, b, what):
    """``sax_encode`` on ``x``: PAA bitwise equal to the in-order sum of
    ``ref.sax_encode_in_order`` (NaN in the same places), every symbol
    equal to ``searchsorted(bp, paa, right=True)`` over the same float32
    table.  Fails the run on a miss; returns ``(paa, sax)``."""
    paa, sax = ops.sax_encode(x, w, b)
    want, sym = ref.sax_encode_in_order(x, w, b)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    if not (torch.equal(torch.isnan(paa), nan)
            and torch.equal(paa[~nan], want[~nan])):
        fail(f"sax_encode PAA differs from the in-order sum at {what}: "
             f"{int((paa != want).sum())} values")
    if not torch.equal(sax.long(), sym):
        fail(f"sax_encode symbols differ from searchsorted at {what}: "
             f"{int((sax.long() != sym).sum())} symbols")
    return paa, sax


def lbpaa_bitwise(torch, ops, ref, a, what):
    """``lb_paa_interval(*a)`` bitwise equal to
    ``ref.lb_paa_interval_in_order``, never NaN.  Fails the run on a miss;
    returns the kernel's bounds."""
    got = ops.lb_paa_interval(*a)
    want = ref.lb_paa_interval_in_order(*a)
    torch.cuda.synchronize()
    if torch.isnan(got).any() or not torch.equal(got, want):
        fail(f"lb_paa_interval differs from the in-order sum at {what} "
             f"[{a[0].shape[0]},{a[2].shape[0]},{a[0].shape[1]}]: "
             f"{int((got != want).sum())} values")
    return got


def check_sax_edges(torch, ops, ref, gen) -> None:
    """``sax_encode`` at ``SAX_EDGES`` bitwise (:func:`sax_bitwise`), each
    also one float off 16-byte alignment (the 4-byte copy instance) and
    with its rows rotated by 5, both equal to the aligned call's bits
    moved with the rows, and in a second call."""
    for B, n, w, b in SAX_EDGES:
        x = torch.randn(B, n, generator=gen, device="cuda")
        what = f"[{B},{n}] w={w} b={b}"
        base = sax_bitwise(torch, ops, ref, x, w, b, what)
        for label, xx, k in (("offset", unaligned(torch, x), 0),
                             ("rows rotated by 5", torch.roll(x, 5, 0), 5),
                             ("second call", x, 0)):
            got = sax_bitwise(torch, ops, ref, xx, w, b,
                              f"{what} {label}")
            if not all(torch.equal(g, torch.roll(t, k, 0))
                       for g, t in zip(got, base)):
                fail(f"sax_encode at {what}: {label} changes the bits")
    print(f"  sax_encode edges [B, n, w, b] in {SAX_EDGES}: bitwise equal "
          f"to the in-order sum and searchsorted, aligned and offset; the "
          f"same rows rotated and in a second call give the same bits")


def check_lbpaa_edges(torch, ops, ref, lo, hi, dprep, n, gen) -> None:
    """``lb_paa_interval`` at ``LBPAA_EDGES`` (each with a ``+inf`` pad
    leaf last) bitwise (:func:`lbpaa_bitwise`) and within rtol = atol =
    1e-6 of its twin, aligned and one float off 16-byte alignment; then the
    DTW intervals against the shard-0 table at other positions: queries
    rotated by 5, the table 37 rows later, unaligned copies, a second
    call."""
    def intervals(rows, w):
        a = torch.randn(rows, w, generator=gen, device="cuda")
        return a, a + torch.randn(rows, w, generator=gen, device="cuda").abs()

    for Q, L, w in LBPAA_EDGES:
        sl, sh = intervals(Q, w)
        rl, rh = intervals(L, w)
        rl[-1], rh[-1] = float("inf"), float("inf")
        for a in ((sl, sh, rl, rh, 4 * w + 1),
                  tuple(unaligned(torch, t) for t in (sl, sh, rl, rh))
                  + (4 * w + 1,)):
            got = lbpaa_bitwise(torch, ops, ref, a, "edge")
            torch.testing.assert_close(got, ref.lb_paa_interval_ref(*a),
                                       rtol=1e-6, atol=1e-6)
    print(f"  lb_paa_interval edges [Q, L, w] in {LBPAA_EDGES}: bitwise "
          f"equal to the in-order sum and within 1e-6 of the twin, aligned "
          f"and offset, +inf pad leaf +inf")
    base = ops.lb_paa_interval(dprep[0], dprep[1], lo, hi, n)
    pre_lo, pre_hi = intervals(37, lo.shape[1])
    checks = {
        "second call": (ops.lb_paa_interval(dprep[0], dprep[1], lo, hi, n),
                        base),
        "query rows rotated by 5": (
            ops.lb_paa_interval(torch.roll(dprep[0], 5, 0),
                                torch.roll(dprep[1], 5, 0), lo, hi, n),
            torch.roll(base, 5, 0)),
        "table 37 rows later": (
            ops.lb_paa_interval(dprep[0], dprep[1],
                                torch.cat([pre_lo, lo]),
                                torch.cat([pre_hi, hi]), n)[:, 37:], base),
        "unaligned operands": (
            ops.lb_paa_interval(*(unaligned(torch, t) for t in
                                  (dprep[0], dprep[1], lo, hi)), n), base)}
    torch.cuda.synchronize()
    for what, (got, want) in checks.items():
        if not torch.equal(got, want):
            fail(f"lb_paa_interval is not position-invariant: {what} "
                 f"changes {int((got != want).sum())} values")
    print(f"  lb_paa_interval DTW [{base.shape[0]},{base.shape[1]},"
          f"{lo.shape[1]}] bitwise equal across: {', '.join(checks)}")


def check_kernels(torch, ops, ref, breakpoints, query_prep, dtw_metric,
                  qs_all, dev, n_iter, floor):
    """Phase 4: every kernel against its twin; returns the kernel table
    rows without ``launches``.  ``sax_encode`` and ``lb_paa_interval`` are
    timed before their edge cases run."""
    qs_main = qs_all[:BATCH]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []

    # -- sax_encode: PAA within 1e-6 of the twin and bitwise equal to the
    # in-order sum; every symbol equal to searchsorted over the same table --
    err, differ = 0.0, 0
    cases = [(qs_main, 16, 8),
             (qs_main[:1].contiguous(), 16, 8),
             (torch.randn(300, 96, generator=gen, device="cuda"), 12, 8)]
    for x, w, b in cases:
        paa, sax = sax_bitwise(torch, ops, ref, x, w, b,
                               f"{tuple(x.shape)} w={w}")
        paa_r, sax_r = ref.sax_encode_ref(x, w, b)
        torch.cuda.synchronize()
        torch.testing.assert_close(paa, paa_r, rtol=1e-6, atol=1e-6)
        bp = torch.as_tensor(breakpoints(b), dtype=torch.float32,
                             device="cuda")
        clear = (paa_r[..., None] - bp).abs().min(dim=-1).values > 1e-5
        if not torch.equal(sax[clear], sax_r[clear]):
            fail(f"sax_encode symbols differ away from breakpoints at "
                 f"{tuple(x.shape)} w={w}")
        differ += int((sax != sax_r).sum())
        err = max(err, float((paa - paa_r).abs().max()))
        print(f"  sax_encode {tuple(x.shape)} w={w} b={b}: bitwise equal to "
              f"the in-order sum and to searchsorted; twin paa max |err| "
              f"{float((paa - paa_r).abs().max()):.3e}, symbols differing "
              f"from the twin's {int((sax != sax_r).sum())}")
    B, n = qs_main.shape
    xs = [(qs_main, 16, 8)] * n_iter
    ms, host = time_ms(torch, ops.sax_encode, xs)
    plain, _ = time_ms(torch, ref.sax_encode_ref, xs)
    b_ms, b_by = bound(4 * (B * n + 2 * B * 16 + 255),
                       B * n + B * 16 + B * 16 * 8)
    rows.append(dict(name="sax_encode", route="cuda", shape=(B, n),
                     source="src/repro_torch/kernels/csrc/sax_encode.cu",
                     replaces="src/repro/kernels/sax_encode.py:68",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None))
    print(f"  sax_encode [64,256]: kernel {ms:.5f} ms (host {host:.4f} ms "
          f"per call; launch floor + {(ms - floor) * 1e3:.3f} us), twin "
          f"{plain:.5f} ms, bound {b_ms:.6f} ms ({b_by}); symbols "
          f"differing from the twin's in all cases {differ}")
    # at scale: the whole resident shard, the collection a device build
    # encodes (bitwise too)
    db0 = dev.db[0]
    Bs = db0.shape[0]
    sax_bitwise(torch, ops, ref, db0, 16, 8,
                f"dev.db[0] {tuple(db0.shape)}")
    ms_s, host_s = time_ms(torch, ops.sax_encode, [(db0, 16, 8)] * 5)
    bs_ms, bs_by = bound(4 * (Bs * n + 2 * Bs * 16 + 255),
                         Bs * n + Bs * 16 + Bs * 16 * 8)
    print(f"  sax_encode at scale dev.db[0] [{Bs},{n}] w=16 b=8: bitwise "
          f"equal; kernel {ms_s:.5f} ms (host {host_s:.4f} ms per call), "
          f"bound {bs_ms:.6f} ms ({bs_by}), {100 * bs_ms / ms_s:.1f}% of "
          f"the bound, {4 * Bs * n / ms_s / 1e6:.1f} GB/s read")

    # -- pairwise_l2: |err| <= 1e-5 (|q|^2 + |x|^2) --------------------------
    err = 0.0
    cases = [(qs_main, db0[:CHUNK]),
             (torch.randn(17, 96, generator=gen, device="cuda"),
              torch.randn(333, 96, generator=gen, device="cuda"))]
    for q, x in cases:
        got = ops.pairwise_l2(q, x)
        want = ref.pairwise_l2_ref(q, x)
        torch.cuda.synchronize()
        scale = (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
        if not bool(((got - want).abs() <= 1e-5 * scale).all()):
            fail(f"pairwise_l2 disagrees with its twin at "
                 f"{tuple(q.shape)}x{tuple(x.shape)}: max rel "
                 f"{float(((got - want).abs() / scale).max()):.3e}")
        err = max(err, float((got - want).abs().max()))
        print(f"  pairwise_l2 [{q.shape[0]},{x.shape[0]},{q.shape[1]}]: max "
              f"|err| {float((got - want).abs().max()):.3e}")
    err = max(err, check_pairwise_l2_edges(torch, ops, ref, qs_main, db0,
                                           gen))
    # a fresh slab per call, as the span loop reads it: cold in L2
    n_slabs = min(n_iter, db0.shape[0] // CHUNK)
    slabs = [(qs_main, db0[i * CHUNK:(i + 1) * CHUNK]) for i in range(n_slabs)]
    ms, host = time_ms(torch, ops.pairwise_l2, slabs)
    plain, _ = time_ms(torch, ref.pairwise_l2_ref, slabs)
    lib, _ = time_ms(torch, lambda q, x: torch.cdist(q, x).square(), slabs)
    Q, X = B, CHUNK
    b_ms, b_by = bound(4 * (Q * n + X * n + Q * X),
                       2 * Q * X * n + 2 * (Q + X) * n + 4 * Q * X)
    rows.append(dict(name="pairwise_l2", route="cuda", shape=(Q, X, n),
                     source="src/repro_torch/kernels/csrc/pairwise_l2.cu",
                     replaces="src/repro/kernels/pairwise_l2.py:61",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib))
    print(f"  pairwise_l2 [64,2048,256]: kernel {ms:.5f} ms (host {host:.4f}"
          f" ms per call), twin {plain:.5f} ms, yardstick "
          f"torch.cdist(q, x).square() {lib:.5f} ms, bound {b_ms:.6f} ms "
          f"({b_by})")

    # -- lb_paa_interval: rtol = atol = 1e-6 of the twin, bitwise equal to
    # the in-order sum; the +inf pad leaf stays +inf ------------------------
    paa, _ = ops.sax_encode(qs_main, 16, 8)
    dprep = query_prep(dtw_metric, qs_main, paa)
    lo, hi = dev.leaf_lo[0], dev.leaf_hi[0]
    rlo = torch.randn(77, 16, generator=gen, device="cuda")
    rhi = rlo + torch.randn(77, 16, generator=gen, device="cuda").abs()
    slo = torch.randn(9, 16, generator=gen, device="cuda")
    shi = slo + torch.randn(9, 16, generator=gen, device="cuda").abs()
    err = 0.0
    for a in ((paa, paa, lo, hi, n), (dprep[0], dprep[1], lo, hi, n),
              (slo, shi, rlo, rhi, 128)):
        got = lbpaa_bitwise(torch, ops, ref, a, "main")
        want = ref.lb_paa_interval_ref(*a)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        fin = torch.isfinite(want)
        e = float((got[fin] - want[fin]).abs().max())
        err = max(err, e)
        print(f"  lb_paa_interval [{a[0].shape[0]},{a[2].shape[0]},"
              f"{a[0].shape[1]}]: bitwise equal to the in-order sum; twin "
              f"max |err| {e:.3e}, +inf entries {int((~fin).sum())}")
    L = lo.shape[0]
    b_ms, b_by = bound(4 * (2 * B * 16 + 2 * L * 16 + B * L),
                       7 * B * L * 16 + B * L)
    for label, a in (("ED", (paa, paa, lo, hi, n)),
                     ("DTW shared", (dprep[0], dprep[1], lo, hi, n))):
        args = [a] * n_iter
        ms, host = time_ms(torch, ops.lb_paa_interval, args)
        plain, _ = time_ms(torch, ref.lb_paa_interval_ref, args)
        if label == "ED":
            rows.append(dict(
                name="lb_paa_interval", route="cuda", shape=(B, L, 16),
                source="src/repro_torch/kernels/csrc/lb_paa_interval.cu",
                replaces="src/repro/kernels/lb_isax.py:61", max_abs_err=err,
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None))
        print(f"  lb_paa_interval [64,{L},16] {label}: kernel {ms:.5f} ms "
              f"(host {host:.4f} ms per call; launch floor + "
              f"{(ms - floor) * 1e3:.3f} us), twin {plain:.5f} ms, bound "
              f"{b_ms:.6f} ms ({b_by})")
    # at scale: the 256 held-out queries against the leaf table of a
    # 100 M-series collection, the shard-0 table repeated 25 times
    paa_all, _ = ops.sax_encode(qs_all, 16, 8)
    big = (paa_all, paa_all, lo.repeat(LB_SCALE, 1), hi.repeat(LB_SCALE, 1),
           n)
    lbpaa_bitwise(torch, ops, ref, big, "at scale")
    Qs, Ls = paa_all.shape[0], big[2].shape[0]
    ms_s, host_s = time_ms(torch, ops.lb_paa_interval, [big] * n_iter)
    bs_ms, bs_by = bound(4 * (2 * Qs * 16 + 2 * Ls * 16 + Qs * Ls),
                         7 * Qs * Ls * 16 + Qs * Ls)
    print(f"  lb_paa_interval at scale [{Qs},{Ls},16]: bitwise equal; "
          f"kernel {ms_s:.5f} ms (host {host_s:.4f} ms per call), bound "
          f"{bs_ms:.6f} ms ({bs_by}), {100 * bs_ms / ms_s:.1f}% of the "
          f"bound")
    check_sax_edges(torch, ops, ref, gen)
    check_lbpaa_edges(torch, ops, ref, lo, hi, dprep, n, gen)
    return rows


def wall_ms(torch, fn, args_list) -> float:
    """Wall ms per call, synchronized, after one warm-up call: for a plain
    version that reads the device's state on the host every step (it cannot
    be queued behind a held stream), so host and device time together."""
    fn(*args_list[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(args_list)


def dtw_cells(n: int, r: int) -> int:
    """In-band cells of one n x n Sakoe-Chiba DP of radius r."""
    r = min(r, n - 1)
    return n * (2 * r + 1) - r * (r + 1)


def dtw_call_work(torch, gather, q, x, mask, cut, r, idx, clock_hz):
    """The twin's answer to one ``dtw_band`` call and what that call must
    do: ``(twin out, bound ms, bound_by, chain floor ms)``.
    The bound counts each input read once (the query rows, the candidate
    rows of the lanes on, idx, mask, cutoff) and the output written once,
    against ``DTW_CELL_OPS`` operations for each in-band cell a lane
    computed before the twin abandoned it (the twin counts each lane's
    diagonals).  The chain floor is the longest lane's diagonals at
    ``CHAIN_STEP_CYCLES`` each; the kernel cannot beat it without a
    shorter chain, whatever its parallelism."""
    Q, n = q.shape
    m = mask.shape[1]
    xs = x[idx] if idx is not None else (x if x.dim() == 3
                                         else x.expand(Q, -1, -1))
    want, steps = gather(q, xs, r, mask, cut, return_steps=True)
    rr = min(r, n - 1)
    i = torch.arange(n, device=q.device)
    j = torch.arange(2 * n - 1, device=q.device)[:, None] - i
    per_diag = ((j >= 0) & (j < n) & ((i - j).abs() <= rr)).sum(1)
    cum = torch.cat([per_diag.new_zeros(1), per_diag.cumsum(0)])
    cells = int(cum[steps].sum())
    if idx is not None:
        rows = int(torch.unique(idx[mask]).numel())
    else:
        rows = int(mask.sum()) if x.dim() == 3 else int(mask.any(0).sum())
    moved = (4 * (Q * n + rows * n + Q + Q * m) + Q * m
             + (8 * Q * m if idx is not None else 0))
    b_ms, b_by = bound(moved, DTW_CELL_OPS * cells)
    chain = int(steps.max()) * CHAIN_STEP_CYCLES / clock_hz * 1e3
    return want, b_ms, b_by, chain


def check_dtw_kernels(torch, ops, ref, envelope, gather, qs_main, dev,
                      n_iter, clock_hz):
    """Phase 4, DTW half: ``lb_keogh`` and ``lb_improved`` within rtol 1e-5
    of their twins (two sums of n nonnegative float32 terms in different
    orders, each within (n-1)·2^-24 of the exact sum), ``dtw_band`` bitwise
    with the same ``+inf`` lanes; returns the kernel table rows without
    ``launches``."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    db0 = dev.db[0]
    Q, n = qs_main.shape
    U, L = envelope(qs_main, BAND)
    slab, sub = db0[:CHUNK], db0[:256]
    # a lane-walk chunk: each query's 128 lanes of least LB_Improved in the
    # slab, the cutoff at their 10th best DTW², the mask the cascade's
    lbi = ref.lb_improved_ref(slab, qs_main, U, L, BAND)
    idx = torch.argsort(lbi, dim=1, stable=True)[:, :128].contiguous()
    inf_cut = torch.full((Q,), float("inf"), device="cuda")
    on = torch.ones((Q, 128), dtype=torch.bool, device="cuda")
    cut = ref.dtw_band_ref(qs_main, slab, on, inf_cut, BAND,
                           idx=idx).kthvalue(K, dim=1).values
    mask = torch.gather(lbi, 1, idx) < cut[:, None]
    gathered = slab[idx].contiguous()                       # [64, 128, 256]
    lbi_sub = ref.lb_improved_ref(sub, qs_main, U, L, BAND)
    cut_sub = ref.dtw_band_ref(qs_main, sub, lbi_sub < float("inf"),
                               inf_cut, BAND).kthvalue(K, dim=1).values
    mask_sub = lbi_sub < cut_sub[:, None]

    def walks(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").cumsum(-1)

    rq, rx, rc = walks(5, 96), walks(77, 96), walks(5, 77, 96)
    ragged = []
    for r in (7, 95, 120):                       # 95, 120: r + 1 >= n
        rU, rL = (t.clone() for t in envelope(rq, r))
        rU[:, 0], rL[:, 0] = float("inf"), -float("inf")   # unbounded edge
        full = ref.dtw_band_ref(rq, rx, torch.ones((5, 77), dtype=torch.bool,
                                                   device="cuda"),
                                torch.full((5,), float("inf"),
                                           device="cuda"), r)
        rmask = torch.rand((5, 77), generator=gen, device="cuda") < 0.7
        ragged.append((r, rU, rL, rmask, full.quantile(0.25, dim=1)))
    # a band past the shared-memory frontier's cap: the frontier in scratch
    wQ, wm, wn, wr = DTW_WIDE
    wq, wx, wc = walks(wQ, wn), walks(wm, wn), walks(wQ, wm, wn)
    won = torch.ones((wQ, wm), dtype=torch.bool, device="cuda")
    winf = torch.full((wQ,), float("inf"), device="cuda")
    wcut = ref.dtw_band_ref(wq, wx, won, winf, wr).quantile(0.5, dim=1)

    # -- lb_keogh, lb_improved ------------------------------------------------
    lb_cases = [(slab, qs_main, U, L, BAND), (sub, qs_main, U, L, BAND),
                (gathered, qs_main, U, L, BAND)]
    for r, rU, rL, _, _ in ragged:
        lb_cases += [(rx, rq, rU, rL, r), (rc, rq, rU, rL, r)]
    errs = {"lb_keogh": 0.0, "lb_improved": 0.0}
    for x, q, u, lo, r in lb_cases:
        for name, got, want in (
                ("lb_keogh", ops.lb_keogh(x, u, lo), ref.lb_keogh_ref(x, u, lo)),
                ("lb_improved", ops.lb_improved(x, q, u, lo, r),
                 ref.lb_improved_ref(x, q, u, lo, r))):
            torch.cuda.synchronize()
            if torch.isnan(got).any():
                fail(f"{name} produced NaN at {tuple(x.shape)} r={r}")
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            e = float(((got - want).abs() / want.clamp_min(1e-30)).max())
            errs[name] = max(errs[name], float((got - want).abs().max()))
            print(f"  {name} x{tuple(x.shape)} Q={q.shape[0]} r={r}: max "
                  f"|err| {float((got - want).abs().max()):.3e}, max rel "
                  f"{e:.3e}")
    errs["lb_keogh"] = max(errs["lb_keogh"], check_lb_keogh_edges(
        torch, ops, ref, envelope, db0, U, L, idx, gathered, gen))

    # -- dtw_band: bitwise, +inf lanes included -------------------------------
    dp_cases = [("rows", qs_main, slab, mask, cut, BAND, idx),
                ("gather", qs_main, gathered, mask, cut, BAND, None),
                ("shared", qs_main, sub, mask_sub, cut_sub, BAND, None)]
    for r, _, _, rmask, rcut in ragged:
        dp_cases += [("shared", rq, rx, rmask, rcut, r, None),
                     ("gather", rq, rc, rmask, rcut * 2, r, None)]
    dp_cases += [("shared", wq, wx, won, wcut, wr, None),
                 ("gather", wq, wc, won, wcut, wr, None)]
    for layout, q, x, mk, ct, r, ix in dp_cases:
        got = ops.dtw_band(q, x, mk, ct, r, idx=ix)
        want = ref.dtw_band_ref(q, x, mk, ct, r, idx=ix)
        torch.cuda.synchronize()
        if not (torch.equal(torch.isinf(got), torch.isinf(want))
                and torch.equal(got, want)):
            fail(f"dtw_band differs from its twin ({layout}, "
                 f"{tuple(mk.shape)}, n={q.shape[1]}, r={r})")
        print(f"  dtw_band {layout} {tuple(mk.shape)} n={q.shape[1]} r={r}: "
              f"bitwise equal; lanes on {int(mk.sum())}, finished "
              f"{int(torch.isfinite(got).sum())}")

    rows = []
    # LB kernels at the lane program's precompute shape: a fresh
    # 2048-row slab of the collection per call, cold in L2
    n_slabs = min(n_iter, db0.shape[0] // CHUNK)
    slabs = [db0[i * CHUNK:(i + 1) * CHUNK] for i in range(n_slabs)]
    m = CHUNK
    for name, src, line, fn, plain, per_el, args in (
            ("lb_keogh", "lb_keogh.cu", "lb_keogh.py:77", ops.lb_keogh,
             ref.lb_keogh_ref, LBK_OPS, [(x, U, L) for x in slabs]),
            ("lb_improved", "lb_improved.cu", "lb_keogh.py:113",
             ops.lb_improved, ref.lb_improved_ref, LBI_OPS,
             [(x, qs_main, U, L, BAND) for x in slabs])):
        ms, host = time_ms(torch, fn, args)
        # the LB_Improved twin allocates a dozen [64, 2048, 256] temporaries
        # per call, too slow to queue behind a held stream: wall time
        plain_ms = (time_ms(torch, plain, args)[0] if name == "lb_keogh"
                    else wall_ms(torch, plain, args[:10]))
        n_env = 2 if name == "lb_keogh" else 3
        b_ms, b_by = bound(4 * (m * n + n_env * Q * n + Q * m),
                           per_el * Q * m * n)
        rows.append(dict(name=name, route="cuda", shape=(Q, m, n),
                         source=f"src/repro_torch/kernels/csrc/{src}",
                         replaces=f"src/repro/kernels/{line}",
                         max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))
        print(f"  {name} [{Q},{m},{n}] r={BAND}: kernel {ms:.5f} ms (host "
              f"{host:.4f} ms per call), twin {plain_ms:.5f} ms, bound "
              f"{b_ms:.6f} ms ({b_by})")
    # lb_keogh's issue bound (the kernel's instructions an element at 128
    # lanes a clock on every SM), and its time at the "shared" order's
    # 256-row sub-slab and at the lane walk's gathered [64, 128, 256] chunk
    # (the per-query layout, a fresh chunk per call)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def issue_ms(elements):
        return (LBK_KERNEL_INSTR * elements
                / (LANES_PER_SM * sms * clock_hz) * 1e3)

    print(f"  lb_keogh [{Q},{m},{n}]: issue bound at {LBK_KERNEL_INSTR} "
          f"instructions an element, {sms} SMs at {clock_hz / 1e9:.3f} GHz:"
          f" {issue_ms(Q * m * n):.6f} ms")
    n_sub = min(n_iter, db0.shape[0] // 256)
    gathers = [db0[i * CHUNK:(i + 1) * CHUNK][idx].contiguous()
               for i in range(min(n_iter, db0.shape[0] // CHUNK))]
    for label, args, moved in (
            ("shared order's sub-slab [64,256,256]",
             [(db0[i * 256:(i + 1) * 256], U, L) for i in range(n_sub)],
             4 * (256 * n + 2 * Q * n + Q * 256)),
            ("gathered chunk [64,128,256], per query",
             [(g, U, L) for g in gathers],
             4 * (Q * 128 * n + 2 * Q * n + Q * 128))):
        x = args[0][0]
        el = Q * x.shape[-2] * n
        ms, host = time_ms(torch, ops.lb_keogh, args)
        plain, _ = time_ms(torch, ref.lb_keogh_ref, args)
        b_ms, b_by = bound(moved, LBK_OPS * el)
        print(f"  lb_keogh at the {label}: kernel {ms:.5f} ms (host "
              f"{host:.4f} ms per call), twin {plain:.5f} ms, bound "
              f"{b_ms:.6f} ms ({b_by}), byte bound "
              f"{moved / HBM_BYTES_PER_S * 1e3:.6f} ms, issue bound "
              f"{issue_ms(el):.6f} ms")
    del gathers
    # lb_improved's bound at its own operation count too, and its time at
    # the "shared" order's 256-row sub-slab beside both bounds
    k_ms, k_by = bound(4 * (m * n + 3 * Q * n + Q * m),
                       LBI_KERNEL_OPS * Q * m * n)
    print(f"  lb_improved [{Q},{m},{n}]: bound at the kernel's "
          f"{LBI_KERNEL_OPS} operations an element {k_ms:.6f} ms ({k_by})")
    args = [(db0[i * 256:(i + 1) * 256], qs_main, U, L, BAND)
            for i in range(n_sub)]
    ms, host = time_ms(torch, ops.lb_improved, args)
    b_ms, b_by = bound(4 * (256 * n + 3 * Q * n + Q * 256),
                       LBI_OPS * Q * 256 * n)
    k_ms, k_by = bound(4 * (256 * n + 3 * Q * n + Q * 256),
                       LBI_KERNEL_OPS * Q * 256 * n)
    print(f"  lb_improved [{Q},256,{n}] r={BAND}: kernel {ms:.5f} ms (host "
          f"{host:.4f} ms per call), bound {b_ms:.6f} ms ({b_by}; "
          f"{k_ms:.6f} ms at {LBI_KERNEL_OPS} operations)")

    # dtw_band at the lane walk's chunk: [64, 128] rows of the collection,
    # with the cutoff at each query's 10th best and with none; the row of
    # the kernel table is set from the walk's own calls (phase 7)
    for label, ct in (("with cutoff", cut), ("without cutoff", inf_cut)):
        args = [(qs_main, slab, mask, ct, BAND, idx)] * n_iter
        ms, host = time_ms(torch, ops.dtw_band, args)
        plain_ms = wall_ms(torch, ref.dtw_band_ref, args[:5])
        want, b_ms, b_by, chain = dtw_call_work(torch, gather, *args[0],
                                                clock_hz)
        print(f"  dtw_band rows [{Q},128] n={n} r={BAND} {label}: "
              f"{int(mask.sum())} lanes on, "
              f"{int(torch.isfinite(want).sum())} finished, kernel "
              f"{ms:.5f} ms (host {host:.4f} ms per call), twin "
              f"{plain_ms:.5f} ms (wall), "
              f"bound {b_ms:.6f} ms ({b_by}), chain floor {chain:.6f} ms")
    # the wide path past the cap, no cutoff: every lane runs every cell
    args = [(wq, wx, won, winf, wr, None)] * 5
    ms, _ = time_ms(torch, ops.dtw_band, args, warmup=1)
    _, b_ms, b_by, chain = dtw_call_work(torch, gather, *args[0], clock_hz)
    print(f"  dtw_band wide path shared [{wQ},{wm}] n={wn} r={wr} without "
          f"cutoff ({dtw_cells(wn, wr)} cells a lane): kernel {ms:.5f} ms, "
          f"bound {b_ms:.6f} ms ({b_by}), chain floor {chain:.6f} ms")
    rows.append(dict(name="dtw_band", route="cuda",
                     source="src/repro_torch/kernels/csrc/dtw_band.cu",
                     replaces="src/repro/kernels/dtw_band.py:94",
                     max_abs_err=0.0,
                     wide=dict(shape=DTW_WIDE, ms=ms, bound_ms=b_ms,
                               bound_by=b_by)))
    return rows


def schedule_rows(torch, np, dev, leaves):
    """``rows_of(qi)``: the rows (of the one-shard layout, whose flattened
    coordinates are shard 0's) of the leaves ``leaves [Q, nbr]`` a search
    scheduled for query ``qi``, as an index tensor on the layout's device.
    On a fuzzy layout each id keeps its first row only: its replicas hold
    the same series, and a top-k counts an id once."""
    start = dev.leaf_start.cpu().numpy()
    size = dev.leaf_size.cpu().numpy()
    ids = dev.ids[0].cpu().numpy() if dev.has_duplicates else None

    def rows_of(qi):
        rows = np.concatenate([np.arange(start[lf], start[lf] + size[lf])
                               for lf in leaves[qi] if lf >= 0])
        if ids is not None:
            rows = rows[np.sort(np.unique(ids[rows], return_index=True)[1])]
        return torch.from_numpy(rows).to(dev.db[0].device)

    return rows_of


def dtw_float64_check(torch, dev, q32, d_port, r, k, rows_of=None):
    """Independent float64 DTW top-(k+1) of ``q32 [Q, n]`` over every live
    row of shard 0, or with ``rows_of(qi)`` over the live rows it gives for
    query ``qi`` (the leaves a search scheduled).  LB_Keogh in float64 (its
    own envelope) over every row, then a float64 banded DP over the rows
    whose LB is at most the port's k-th distance × (1 + 1e-5) (every row
    where the port returned fewer than k).  That is exact: LB ≤ DTW, and
    the port's k-th distance is the DTW of a real row, so it is at least
    the true k-th.  LB_Improved in float64 then drops more pairs, by the
    same test, and a pair leaves the DP, +inf, once its partial cost
    passes that bound.  Returns ``(d [Q, k+1]
    f64, ids [Q, k+1], rows given the DP)``, padded with ``inf / -1``."""
    F = torch.nn.functional
    inf = float("inf")
    db0, ids0, alive0 = dev.db[0], dev.ids[0], dev.alive[0]
    on = db0.device
    Q, n = q32.shape
    q = q32.double()
    U = F.pad(q, (r, r), value=-inf).unfold(1, 2 * r + 1, 1).amax(-1)
    L = F.pad(q, (r, r), value=inf).unfold(1, 2 * r + 1, 1).amin(-1)
    thr = (torch.as_tensor(d_port[:, k - 1], dtype=torch.float64,
                           device=on) * (1 + 1e-5)) ** 2
    qi_l, row_l = [], []
    step = 4096
    if rows_of is None:
        for c0 in range(0, db0.shape[0], step):
            x = db0[c0:c0 + step].double()[None]
            e = (x - U[:, None]).clamp_min(0) + (L[:, None] - x).clamp_min(0)
            keep = (((e * e).sum(-1) <= thr[:, None])
                    & alive0[None, c0:c0 + step])
            qi, j = keep.nonzero(as_tuple=True)
            qi_l.append(qi)
            row_l.append(j + c0)
    else:
        for qq in range(Q):
            rows = rows_of(qq)
            x = db0[rows].double()
            e = (x - U[qq]).clamp_min(0) + (L[qq] - x).clamp_min(0)
            keep = ((e * e).sum(-1) <= thr[qq]) & alive0[rows]
            row_l.append(rows[keep])
            qi_l.append(torch.full_like(row_l[-1], qq))
    qi, rows = torch.cat(qi_l), torch.cat(row_l)
    # LB_Improved in float64 over the pairs LB_Keogh kept: LB_Keogh plus
    # LB_Keogh of q against the envelope of x clipped to q's envelope
    keep = []
    for p0 in range(0, len(rows), 1 << 16):
        qq, x = qi[p0:p0 + (1 << 16)], db0[rows[p0:p0 + (1 << 16)]].double()
        Uq, Lq, a = U[qq], L[qq], q[qq]
        h = torch.minimum(torch.maximum(x, Lq), Uq)[:, None]
        Uh = F.max_pool1d(h, 2 * r + 1, 1, r)[:, 0]
        Lh = -F.max_pool1d(-h, 2 * r + 1, 1, r)[:, 0]
        lb = (((x - Uq).clamp_min(0) ** 2 + (Lq - x).clamp_min(0) ** 2
               ).sum(-1)
              + ((a - Uh).clamp_min(0) ** 2 + (Lh - a).clamp_min(0) ** 2
                 ).sum(-1))
        keep.append(lb <= thr[qq])
    if keep:
        keep = torch.cat(keep)
        qi, rows = qi[keep], rows[keep]
    # the DP over the (query, row) pairs, anti-diagonal by anti-diagonal:
    # slot t of diagonal d = i + j holds D(i, j) with i - j = t - r
    # A step moves i + j on by 1 or 2, so every warping path meets one of
    # two neighbouring diagonals, and (costs being >= 0) their least cell
    # bounds the final DTW²: every DTW_ABANDON_EVERY diagonals the pairs
    # above their bound ``thr`` leave the DP, as they left it at the LB
    # test, and keep +inf.
    T = 2 * r + 1
    tt = torch.arange(T, device=on) - r
    dist = torch.full((len(rows),), inf, dtype=torch.float64, device=on)
    chunk = 1 << 19
    for p0 in range(0, len(rows), chunk):
        pos = torch.arange(p0, min(p0 + chunk, len(rows)), device=on)
        a = q[qi[pos]]
        b = db0[rows[pos]].double()
        cut = thr[qi[pos]]
        P = a.shape[0]
        d1 = torch.full((P, T), inf, dtype=torch.float64, device=on)
        d2 = d1.clone()
        for d in range(2 * n - 1):
            i2 = d + tt
            i, j = i2 // 2, (d - tt) // 2
            valid = (i2 % 2 == 0) & (i >= 0) & (i < n) & (j >= 0) & (j < n)
            c = (b[:, j.clamp(0, n - 1)] - a[:, i.clamp(0, n - 1)]) ** 2
            pad = torch.full((len(pos), 1), inf, dtype=torch.float64,
                             device=on)
            up = torch.cat([pad, d1[:, :-1]], 1)          # D(i-1, j)
            left = torch.cat([d1[:, 1:], pad], 1)         # D(i, j-1)
            best = torch.minimum(torch.minimum(up, left), d2)  # D(i-1, j-1)
            if d == 0:
                best = torch.where(tt == 0, 0.0, best)
            d2, d1 = d1, torch.where(valid, c + best, inf)
            if d % DTW_ABANDON_EVERY == DTW_ABANDON_EVERY - 1:
                go = torch.minimum(d1.amin(1), d2.amin(1)) <= cut
                pos, a, b, cut, d1, d2 = (t[go] for t in (pos, a, b, cut,
                                                          d1, d2))
        dist[pos] = d1[:, r].sqrt()
    bd = torch.full((Q, k + 1), inf, dtype=torch.float64, device=on)
    bi = torch.full((Q, k + 1), -1, dtype=torch.int64, device=on)
    for qq in range(Q):
        sel = qi == qq
        dd, ii = dist[sel], ids0[rows[sel]].long()
        v, j = torch.topk(dd, min(k + 1, dd.numel()), largest=False)
        bd[qq, :len(v)] = v
        bi[qq, :len(v)] = ii[j]
    return bd, bi, len(rows)


def brute_force(torch, dev, q32, k, rows_of=None, live=None):
    """Exact top-(k+1) of ``q32 [Q, n]`` in float64 by direct differences
    over every live row of shard 0 (and of ``live``, a bool mask of its
    rows, where given), or with ``rows_of(qi)`` over the live rows it
    gives for query ``qi`` (the leaves a search scheduled): ``(d [Q, k+1]
    f64, ids [Q, k+1])``, padded with ``inf / -1``."""
    db0, ids0, alive0 = dev.db[0], dev.ids[0], dev.alive[0]
    if live is not None:
        alive0 = alive0 & live
    q = q32.double()
    on = db0.device
    if rows_of is not None:
        Q = q32.shape[0]
        bd = torch.full((Q, k + 1), float("inf"), dtype=torch.float64,
                        device=on)
        bi = torch.full((Q, k + 1), -1, dtype=torch.int64, device=on)
        for qq in range(Q):
            rows = rows_of(qq)
            rows = rows[alive0[rows]]
            d = ((db0[rows].double() - q[qq]) ** 2).sum(-1)
            v, j = torch.topk(d, min(k + 1, d.numel()), largest=False)
            bd[qq, :len(v)] = v.sqrt()
            bi[qq, :len(v)] = ids0[rows[j]].long()
        return bd, bi
    # candidates by |q|² + |x|² - 2 q·x in float64 (a relative error near
    # 1e-15, BRUTE_SLACK rows to spare), then their direct differences
    best_d, best_r = [], []
    step = 8192
    qq = (q * q).sum(-1)[:, None]
    c = k + 1 + BRUTE_SLACK
    for c0 in range(0, db0.shape[0], step):
        x = db0[c0:c0 + step].double()
        d = qq + (x * x).sum(-1)[None, :] - 2.0 * (q @ x.T)
        d = torch.where(alive0[c0:c0 + step][None, :], d, float("inf"))
        v, j = torch.topk(d, min(c, d.shape[1]), dim=1, largest=False)
        best_d.append(v)
        best_r.append(j + c0)
    v, j = torch.topk(torch.cat(best_d, 1), c, dim=1, largest=False)
    rows = torch.gather(torch.cat(best_r, 1), 1, j)
    d = ((db0[rows].double() - q[:, None, :]) ** 2).sum(-1)
    d = torch.where(torch.isinf(v), float("inf"), d)
    v, j = torch.topk(d, k + 1, dim=1, largest=False)
    return v.sqrt(), ids0[torch.gather(rows, 1, j)].long()


def walk_calls(ops, sd, index, qb) -> list:
    """The arguments of every ``dtw_band`` call that the lane walk's steps
    (``search_device._walk_step``) make in one DTW batch of ``qb``."""
    calls, real, step = [], ops.dtw_band, sd._walk_step
    inside = [False]

    def record(qs, xs, mask, cutoff2, r, idx=None):
        if inside[0]:
            calls.append((qs, xs, mask, cutoff2, r, idx))
        return real(qs, xs, mask, cutoff2, r, idx)

    def walking(*a):
        inside[0] = True
        try:
            return step(*a)
        finally:
            inside[0] = False

    ops.dtw_band, sd._walk_step = record, walking
    try:
        sd.exact_search_device_batch(index, qb, K, chunk=CHUNK, metric="dtw",
                                     band=BAND)
    finally:
        ops.dtw_band, sd._walk_step = real, step
    return calls


def check_walk_dtw(torch, ops, gather, calls, clock_hz, n_sample=32):
    """``dtw_band`` at ``n_sample`` of the walk's calls, evenly spaced:
    bitwise against the twin (+inf lanes included), the kernel's device
    time per call (the sample queued 4 times), the twin's wall time, and
    the mean bound and chain floor of the same calls.  Returns the kernel
    table fields."""
    step = max(len(calls) // n_sample, 1)
    sample = calls[::step][:n_sample]
    plain, bounds, chains = [], [], []
    for a in sample:
        got = ops.dtw_band(*a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, b_ms, b_by, chain = dtw_call_work(torch, gather, *a, clock_hz)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
        if not (torch.equal(torch.isinf(got), torch.isinf(want))
                and torch.equal(got, want)):
            fail(f"dtw_band differs from its twin at a walk call "
                 f"{tuple(a[2].shape)}")
        bounds.append((b_ms, b_by))
        chains.append(chain)
    ms, host = time_ms(torch, ops.dtw_band, sample * 4)
    b_ms = sum(b for b, _ in bounds) / len(bounds)
    by = max(("bytes", "operations"),
             key=lambda k: sum(1 for _, b in bounds if b == k))
    on = sum(int(a[2].sum()) for a in sample) / len(sample)
    print(f"  dtw_band at {len(sample)} of the walk's {len(calls)} calls "
          f"(rows {tuple(sample[0][2].shape)}, {on:.1f} lanes on a call): "
          f"bitwise equal to the twin; kernel {ms:.5f} ms (host "
          f"{host:.4f} ms per call), twin {sum(plain) / len(plain):.5f} ms "
          f"(wall, with its cell count), bound {b_ms:.6f} ms ({by} in "
          f"most), chain floor {sum(chains) / len(chains):.6f} ms")
    return dict(ms=ms, plain_ms=sum(plain) / len(plain), bound_ms=b_ms,
                bound_by=by, library_ms=None)


def check_exact(np, ids, d, bd, bi, true_dist, k) -> int:
    """Hold one batch's result against the float64 check (``bd, bi``).
    Distances agree to rtol 1e-5; an id may differ from the check's only
    where that position's distance is tied (within the same tolerance) with
    a neighbouring position, and then the port's id must be exactly as near
    (``true_dist(query, id)``).  Where the check found fewer than k rows
    (``+inf`` in ``bd``) the result must pad with ``-1 / inf``.  Returns
    the number of tied positions."""
    tol = 1e-5
    fin = np.isfinite(bd[:, :k])
    if not (np.array_equal(np.isfinite(d), fin) and (ids[~fin] == -1).all()):
        fail("result slots and the float64 check's rows differ in number")
    if not np.allclose(d[fin].astype(np.float64), bd[:, :k][fin], rtol=tol,
                       atol=0):
        fail(f"distances disagree with the float64 check (max rel "
             f"{np.max(np.abs(d[fin] - bd[:, :k][fin]) / bd[:, :k][fin]):.3e})")
    tied = 0
    for qi in range(ids.shape[0]):
        m = int(fin[qi].sum())
        if len(set(ids[qi, :m].tolist())) != m or (ids[qi, :m] < 0).any():
            fail(f"query {qi}: ids not unique {ids[qi]}")
        for j in range(m):
            if ids[qi, j] == bi[qi, j]:
                continue
            near = [bd[qi, jj] for jj in (j - 1, j + 1) if 0 <= jj <= k]
            if not any(abs(x - bd[qi, j]) <= tol * bd[qi, j] for x in near):
                fail(f"query {qi} position {j}: id {ids[qi, j]} != float64 "
                     f"check {bi[qi, j]} at an untied distance {bd[qi, j]}")
            true = true_dist(qi, ids[qi, j])
            if abs(true - bd[qi, j]) > tol * bd[qi, j]:
                fail(f"query {qi} position {j}: id {ids[qi, j]} at "
                     f"{true} is not tied with {bd[qi, j]}")
            tied += 1
    return tied


def profile_batch(torch, search, index, qb, host_ops: bool = True,
                  **kw) -> None:
    """One batch of the main path under ``torch.profiler``: device time by
    kernel, and the device's busy share of the batch's wall time (the
    profiler's own overhead lengthens the wall time, so the share is a
    lower bound).  The busy time sums the device-side rows alone (kernels,
    copies): an operator row's self device time repeats its kernels'.
    ``host_ops=False`` records the CUDA activity alone: kernel rows, no
    operator rows, and less than half the trace to read (a DTW batch's
    took ~90 s with both and ~40 s without on an H100 machine's host,
    ``scripts/probe_profile_cost.py``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    if host_ops:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        # lint: allow-timing: the search returns host arrays (synced)
        search(index, qb, K, chunk=CHUNK, **kw)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(getattr(e, "self_device_time_total", 0.0)
                    for e in events if e.device_type != DeviceType.CPU)
    op_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    top = sorted(events, key=lambda e: getattr(e, "self_device_time_total",
                                               0.0), reverse=True)[:10]
    print(f"  profiled batch{'' if host_ops else ' (CUDA activity alone)'}:"
          f" wall {wall:.3f} s, device busy "
          f"{device_us / 1e6:.4f} s ({100 * device_us / 1e6 / wall:.1f}% of "
          f"wall; not measured if 0; all rows summed, operators and their "
          f"kernels both: {op_us / 1e6:.4f} s)")
    for e in top:
        print(f"    {e.key[:60]:60s} calls {e.count:7d} device "
              f"{getattr(e, 'self_device_time_total', 0.0) / 1e3:9.3f} ms "
              f"host {e.self_cpu_time_total / 1e3:9.3f} ms")
    # each of the port's kernels by name (CUDA symbols ``<name>_kernel``
    # and ``<name>_<variant>_kernel``)
    for name in KERNELS:
        hits = [e for e in events if f"{name}_" in e.key
                and "_kernel" in e.key
                and getattr(e, "self_device_time_total", 0.0) > 0]
        dev_ms = sum(e.self_device_time_total for e in hits) / 1e3
        print(f"    kernel {name:16s} calls {sum(e.count for e in hits):7d}"
              f" device {dev_ms:9.3f} ms")


def gather_calls(sd, index, qb, n_keep, **kw) -> list:
    """The arguments of the first ``n_keep`` per-query leaf-rank calls
    (``search_device._dist2_gather``: ``qs, prep, cand [Q, lmax, n], valid,
    cutoff2``) of one extended search of ``qb``."""
    calls, real = [], sd._dist2_gather

    def record(metric, qs, prep, cand, valid, cutoff2):
        if len(calls) < n_keep:
            calls.append((qs, prep, cand, valid, cutoff2))
        return real(metric, qs, prep, cand, valid, cutoff2)

    sd._dist2_gather = record
    try:
        sd.extended_search_device_batch(index, qb, K, **kw)
    finally:
        sd._dist2_gather = real
    return calls


def check_rank_kernels(torch, ops, ref, gather, dev, ed_prep, calls,
                       n_iter, floor, clock_hz, smi) -> None:
    """Phase 9's new kernel calls on the card, each against its plain
    version (bitwise where phase 4 holds the kernel bitwise, else phase 4's
    rtol = atol = 1e-5), its time beside its bound and the launch floor:
    ``lb_paa_interval`` on the routing edge table ``[64, Eg, 16]`` (ED and
    DTW intervals), and ``lb_keogh``, ``lb_improved`` and ``dtw_band`` in
    the per-query layout at the leaf ranks recorded in ``calls``."""
    Eg, w, n = dev.rt_lo.shape[0], dev.w, dev.n
    for label, (slo, shi) in (("ED", ed_prep[:2]), ("DTW", calls[0][1][:2])):
        a = (slo, shi, dev.rt_lo, dev.rt_hi, n)
        lbpaa_bitwise(torch, ops, ref, a, f"routing edges {label}")
        ms, host = time_ms(torch, ops.lb_paa_interval, [a] * n_iter)
        plain, _ = time_ms(torch, ref.lb_paa_interval_ref, [a] * n_iter)
        Q = slo.shape[0]
        b_ms, b_by = bound(4 * (2 * Q * w + 2 * Eg * w + Q * Eg),
                           7 * Q * Eg * w + Q * Eg)
        print(f"  lb_paa_interval routing edges [{Q},{Eg},{w}] {label}: "
              f"bitwise equal to the in-order sum; kernel {ms:.5f} ms (host "
              f"{host:.4f} ms per call; launch floor {floor:.5f} ms + "
              f"{(ms - floor) * 1e3:.3f} us), twin {plain:.5f} ms, bound "
              f"{b_ms:.6f} ms ({b_by}) [{smi}]")
    for j, (q, prep, cand, valid, cut) in enumerate(calls):
        env_lo, env_hi = prep[2], prep[3]
        Q, m, _ = cand.shape
        ct = cut[:, None]
        lbk = ops.lb_keogh(cand, env_hi, env_lo)
        lbi = ops.lb_improved(cand, q, env_hi, env_lo, BAND)
        mask = valid & (lbk < ct) & (lbi < ct)
        for name, got, want in (
                ("lb_keogh", lbk, ref.lb_keogh_ref(cand, env_hi, env_lo)),
                ("lb_improved", lbi,
                 ref.lb_improved_ref(cand, q, env_hi, env_lo, BAND))):
            torch.cuda.synchronize()
            if torch.isnan(got).any() or not torch.allclose(
                    got, want, rtol=1e-5, atol=1e-5):
                fail(f"{name} disagrees with its twin at leaf rank {j} "
                     f"[{Q},{m},{n}]")
            del want
        got = ops.dtw_band(q, cand, mask, cut, BAND)
        want, d_ms, d_by, chain = dtw_call_work(torch, gather, q, cand, mask,
                                                cut, BAND, None, clock_hz)
        torch.cuda.synchronize()
        if not (torch.equal(torch.isinf(got), torch.isinf(want))
                and torch.equal(got, want)):
            fail(f"dtw_band differs from its twin at leaf rank {j}")
        del want
        cutoff = ("none (+inf)" if bool(torch.isinf(cut).all())
                  else "the running k-th best")
        print(f"  leaf rank {j} of a DTW extended batch, nbr=16 (cutoff "
              f"{cutoff}): cand [{Q},{m},{n}], {int(valid.sum())} live "
              f"lanes, {int(mask.sum())} past both LBs, "
              f"{int(torch.isfinite(got).sum())} finished the DP; "
              f"lb_keogh and lb_improved within rtol 1e-5 of their twins, "
              f"dtw_band bitwise")
        el = Q * m * n
        for name, fn, args, b in (
                ("lb_keogh", ops.lb_keogh, (cand, env_hi, env_lo),
                 bound(4 * (el + 2 * Q * n + Q * m), LBK_OPS * el)),
                ("lb_improved", ops.lb_improved,
                 (cand, q, env_hi, env_lo, BAND),
                 bound(4 * (el + 3 * Q * n + Q * m), LBI_OPS * el)),
                ("dtw_band", ops.dtw_band, (q, cand, mask, cut, BAND),
                 (d_ms, d_by))):
            ms, host = time_ms(torch, fn, [args] * n_iter)
            extra = (f", chain floor {chain:.6f} ms" if name == "dtw_band"
                     else "")
            print(f"    {name} per query [{Q},{m},{n}]: kernel {ms:.5f} ms "
                  f"(host {host:.4f} ms per call; launch floor "
                  f"{floor:.5f} ms), bound {b[0]:.6f} ms ({b[1]}){extra} "
                  f"[{smi}]")


def search_paths_phase(torch, np, sd, hs, ops, ref, gather, dtw_np, index,
                       dev, db, batches, dtw_batches, exact_ed, exact_dtw,
                       mods, floor, clock_hz, smi):
    """Phase 9: the approximate and extended searches (paper Alg. 4) on the
    main path's ``DeviceIndex`` and queries.  Every check fails the run on
    a miss; returns the per-configuration summary."""
    builds = index._n_device_builds
    # the host extended_search that check 1 holds batch 0 to runs in a
    # forked process while the card runs the configurations
    host = start_forked(host_search_child, hs, index, batches[0], NBRS)
    qs_ed = np.concatenate(batches)
    gt = {"ED": [set(r.tolist()) for ids, _, _ in exact_ed for r in ids],
          "DTW": [set(r.tolist()) for ids, _, _ in exact_dtw for r in ids]}
    kws = {"ED": {}, "DTW": dict(metric="dtw", band=BAND)}
    configs = ([("ED", "approximate", nbr, None) for nbr in NBRS]
               + [("ED", "extended", nbr, rr) for rr in (True, False)
                  for nbr in NBRS]
               + [("DTW", "extended", nbr, True) for nbr in NBRS])
    caps = [index.routing_flat.stop_span_cap(nbr) for nbr in NBRS]
    print(f"  {dev.n_leaves} leaves, {dev.rt_lo.shape[0]} routing edges, "
          f"depth {dev.depth}, lmax {dev.lmax}; stop_span_cap at nbr {NBRS}: "
          f"{caps} (the reference's schedule window; the port ranks all "
          f"{dev.n_leaves} leaves)")
    # one warm-up call a path (CUDA modules load lazily on first use)
    sd.approximate_search_device_batch(index, batches[0], K)
    sd.extended_search_device_batch(index, batches[0], K)
    sd.extended_search_device_batch(index, dtw_batches[0], K, **kws["DTW"])
    out, summary = {}, []
    for metric, path, nbr, rerank in configs:
        bs = batches if metric == "ED" else dtw_batches
        kw = dict(kws[metric], nbr=nbr)
        if path == "extended":
            fn = sd.extended_search_device_batch
            kw["rerank"] = rerank
        else:
            fn = sd.approximate_search_device_batch
        for m in mods.values():
            m.launches = 0
        torch.cuda.reset_peak_memory_stats()
        res = [fn(index, qb, K, **kw) for qb in bs]       # the checked pass
        per_batch = {name: m.launches / len(bs) for name, m in mods.items()}
        peak = torch.cuda.max_memory_allocated()
        nq = len(bs) * BATCH
        # queries/s: whole passes over the batches, repeated until the
        # window holds QPS_WINDOW_S and QPS_MIN_PASSES passes; the median
        # pass, with the slowest and fastest beside it
        rates, t1 = [], time.perf_counter()
        while (len(rates) < QPS_MIN_PASSES
               or time.perf_counter() - t1 < QPS_WINDOW_S):
            t2 = time.perf_counter()
            for qb in bs:
                fn(index, qb, K, **kw)
            rates.append(nq / (time.perf_counter() - t2))
        window = time.perf_counter() - t1
        qps = float(np.median(rates))
        need = ("sax_encode", "lb_paa_interval") + (
            ("lb_keogh", "lb_improved", "dtw_band") if metric == "DTW"
            else ())
        for name in need:
            if per_batch[name] <= 0:
                fail(f"kernel {name} was not launched on the {metric} "
                     f"{path} path (nbr={nbr})")
        ids = np.concatenate([r[0] for r in res])
        recall = float(np.mean([len(g & set(row[row >= 0].tolist())) / K
                                for g, row in zip(gt[metric], ids)]))
        label = f"{metric} {path} nbr={nbr}" + (
            "" if rerank is None else f" rerank={rerank}")
        print(f"  {label}: {nq} queries in {len(bs)} batches of {BATCH}, "
              f"{len(rates)} passes in {window:.3f} s: median {qps:.2f} qps "
              f"(passes {min(rates):.2f}-{max(rates):.2f}); recall@{K} "
              f"{recall:.7f}; launches a batch {per_batch}; "
              f"max_memory_allocated {peak} bytes [{smi}]")
        out[(metric, path, nbr, rerank)] = res
        summary.append(dict(metric=metric, path=path, nbr=nbr,
                            rerank=rerank, qps=qps, qps_min=min(rates),
                            qps_max=max(rates), passes=len(rates),
                            recall=recall, launches_per_batch=per_batch,
                            max_memory_allocated=peak))

    # -- recall and the k-th distance monotone in nbr ------------------------
    for key in {(m, p, r) for m, p, _, r in configs}:
        rec = [x["recall"] for x in summary
               if (x["metric"], x["path"], x["rerank"]) == key]
        if rec != sorted(rec):
            fail(f"recall is not monotone in nbr on {key}: {rec}")
        kth = [np.concatenate([r[1][:, K - 1] for r in out[key[:2] + (nbr,)
                                                          + key[2:]]])
               for nbr in NBRS]
        for a, b in zip(kth, kth[1:]):
            if not (b <= a).all():
                fail(f"the k-th distance grows with nbr on {key} for "
                     f"{int((b > a).sum())} queries")
    print(f"  recall@{K} and every query's k-th distance monotone in nbr "
          f"{NBRS} on each path")

    # -- leaf schedules: nbr=1 is the host descent; rerank keeps leaves -------
    leaves1 = np.concatenate([r[2] for r in out[("ED", "approximate", 1,
                                                 None)]])
    for i, q in enumerate(qs_ed):
        paa, sax = hs._encode_query(index, q)
        if hs.route_to_leaf(index, paa, sax).leaf_id != leaves1[i, 0]:
            fail(f"approximate nbr=1 query {i}: leaf {leaves1[i, 0]} is "
                 f"not the host route_to_leaf's")
    ext1 = np.concatenate([r[2] for r in out[("ED", "extended", 1, True)]])
    if not np.array_equal(ext1, leaves1):
        fail("extended nbr=1 leaves differ from approximate nbr=1 leaves")
    for nbr in NBRS:
        for a, b in zip(out[("ED", "extended", nbr, True)],
                        out[("ED", "extended", nbr, False)]):
            if not np.array_equal(a[2], b[2]):
                fail(f"extended nbr={nbr}: rerank changes the leaves")
    print(f"  approximate nbr=1 leaves equal the host route_to_leaf for all "
          f"{len(qs_ed)} queries, and extended nbr=1's; rerank=False keeps "
          f"the leaves")

    # -- check 1: ED extended + re-rank bitwise equal to the host -------------
    t1 = time.perf_counter()
    got, wait_s = finish_forked(host, "phase 9's host searches")
    host[0].join(60)
    for nbr in NBRS:
        ids, d, _ = out[("ED", "extended", nbr, True)][0]
        for i, (_, _, ext) in enumerate(got["results"]):
            h_ids, h_d = ext[nbr]
            m = len(h_ids)
            if not (np.array_equal(ids[i, :m], h_ids)
                    and np.array_equal(d[i, :m], h_d)
                    and (ids[i, m:] == -1).all()):
                fail(f"ED extended nbr={nbr} query {i} differs from the "
                     f"host extended_search")
    print(f"  ED extended (rerank=True) bitwise equal to the host "
          f"extended_search for all {BATCH} queries of batch 0 at nbr "
          f"{NBRS} (the host's {got['s']:.3f} s in a forked process beside "
          f"the configurations, {wait_s:.3f} s waited for; "
          f"{time.perf_counter() - t1:.3f} s)")

    # -- check 3: float64 over each query's scheduled leaves ------------------
    t1 = time.perf_counter()
    tied, dp_rows = 0, 0
    for (metric, path, nbr, rerank), res in out.items():
        bs = batches if metric == "ED" else dtw_batches
        for qb, (ids, d, leaves) in zip(bs, res):
            q32 = torch.from_numpy(qb).cuda()
            rows_of = schedule_rows(torch, np, dev, leaves)
            if metric == "ED":
                bd, bi = brute_force(torch, dev, q32, K, rows_of)
                dist = (lambda qi, i, qb=qb: np.sqrt(
                    ((db[i].astype(np.float64)
                      - qb[qi].astype(np.float64)) ** 2).sum()))
            else:
                bd, bi, n_rows = dtw_float64_check(torch, dev, q32, d, BAND,
                                                   K, rows_of)
                dp_rows += n_rows
                dist = (lambda qi, i, qb=qb: dtw_np(qb[qi], db[i], BAND))
            tied += check_exact(np, ids, d, bd.cpu().numpy(),
                                bi.cpu().numpy(), dist, K)
    print(f"  every result of every path ({len(out)} configurations) equals "
          f"the float64 top-{K} over its query's scheduled leaves (ED: "
          f"brute force; DTW: all {N_DTW} queries at every nbr, LB_Keogh "
          f"then the banded DP on {dp_rows} (query, row) pairs); tied "
          f"positions {tied} ({time.perf_counter() - t1:.3f} s)")

    # -- check 5: four shards bitwise equal to one ----------------------------
    t1 = time.perf_counter()
    for metric, rerank in (("ED", True), ("ED", False), ("DTW", True)):
        qb = (batches if metric == "ED" else dtw_batches)[0]
        got = sd.extended_search_device_batch(index, qb, K, nbr=NBRS[-1],
                                              rerank=rerank, n_shards=4,
                                              **kws[metric])
        want = out[(metric, "extended", NBRS[-1], rerank)][0]
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            fail(f"{metric} extended n_shards=4 differs from n_shards=1")
    print(f"  extended nbr={NBRS[-1]} with n_shards=4 bitwise equal to one "
          f"shard: ED (rerank True and False) and DTW, batch 0 "
          f"({time.perf_counter() - t1:.3f} s)")

    # -- the new kernel calls --------------------------------------------------
    t1 = time.perf_counter()
    paa, _ = ops.sax_encode(torch.from_numpy(batches[0]).cuda(), dev.w, 8)
    calls = gather_calls(sd, index, dtw_batches[0], 2, nbr=NBRS[-1],
                         **kws["DTW"])
    check_rank_kernels(torch, ops, ref, gather, dev, (paa, paa), calls,
                       n_iter=20, floor=floor, clock_hz=clock_hz, smi=smi)
    del calls
    print(f"  ({time.perf_counter() - t1:.3f} s)")

    # -- where an extended batch's time goes ----------------------------------
    rng = np.random.default_rng(0)
    for metric, qb in (("ED", batches[0]), ("DTW", dtw_batches[0])):
        met = sd.resolve(metric.lower(), LENGTH, BAND)
        ids_kk = rng.integers(0, db.shape[0], (BATCH, K + 8))
        t1 = time.perf_counter()
        sd._finalize_exact(index, qb, ids_kk, K, met)
        print(f"  host re-rank (_finalize_exact) of one {metric} batch, "
              f"{BATCH} x {K + 8} lanes: {time.perf_counter() - t1:.4f} s "
              f"of host wall")
    for metric, qb in (("ED", batches[1]), ("DTW", dtw_batches[1])):
        print(f"  {metric} extended nbr={NBRS[-1]} rerank=True, profiled "
              f"[{smi}]:")
        profile_batch(torch, sd.extended_search_device_batch, index, qb,
                      nbr=NBRS[-1], **kws[metric])
    if index._n_device_builds != builds:
        fail("phase 9 built another DeviceIndex layout")
    print("  no DeviceIndex built by phase 9")
    return summary, {key: res[0] for key, res in out.items()}


class recorded_calls:
    """Context manager: count every call of the five serving kernels'
    dispatchers (``kernels.ops``) while the block runs, and keep the
    arguments of the first ``keep`` calls of each."""

    def __init__(self, ops, keep: int = 2):
        self.ops, self.keep = ops, keep
        self.calls = {name: [] for name in SERVING_KERNELS}
        self.count = dict.fromkeys(SERVING_KERNELS, 0)

    def __enter__(self):
        self.real = {name: getattr(self.ops, name) for name in SERVING_KERNELS}

        def recorder(name):
            def call(*a, **kw):
                self.count[name] += 1
                if len(self.calls[name]) < self.keep:
                    self.calls[name].append((a, kw))
                return self.real[name](*a, **kw)
            return call

        for name in SERVING_KERNELS:
            setattr(self.ops, name, recorder(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.ops, name, fn)


def ties_only(np, ids, d, r_ids, r_d, rtol: float = 1e-5) -> tuple:
    """``(ok, max rel gap)``: two ``[Q, k]`` answers agree to ``rtol`` in
    their distances (``+inf`` in the same places) and their ids differ only
    between positions whose distances are tied within ``rtol``."""
    if not np.array_equal(np.isinf(d), np.isinf(r_d)):
        return False, float("inf")
    fin = np.isfinite(r_d)
    gap = (float(np.max(np.abs(d[fin] - r_d[fin]) / r_d[fin]))
           if fin.any() else 0.0)
    if gap > rtol:
        return False, gap
    for qi, j in zip(*np.nonzero(ids != r_ids)):
        near = [r_d[qi, jj] for jj in (j - 1, j + 1) if 0 <= jj < d.shape[1]]
        if not any(abs(x - r_d[qi, j]) <= rtol * r_d[qi, j] for x in near):
            return False, gap
    return True, gap


def serving_knobs(B: int, offset: int) -> tuple[list, list, list]:
    """A ladder bucket's lanes: ``k`` cycling 1..10, ``nbr`` cycling 1..4,
    every fourth lane DTW (25%), lane 1 dead (``k = 0``) in buckets of 4
    lanes or more."""
    ks = [1 + (offset + i) % SERVE_K_MAX for i in range(B)]
    nbrs = [1 + (offset + i) % SERVE_NBR_MAX for i in range(B)]
    mets = ["dtw" if (offset + i) % 4 == 3 else "ed" for i in range(B)]
    if B >= 4:
        ks[1] = 0
    return ks, nbrs, mets


def bucket_parity(torch, np, sd, dtw_np, index, dev, db, qs,
                  ladder=SERVE_LADDER) -> dict:
    """Phase 10 (a): a bucket of every ``ladder`` size, each live lane held
    against the same request alone (``extended_search_device_batch(
    rerank=False)``) — schedules bitwise; ids and distances bitwise, or
    else counted (fault C7) and held ties-only at rtol 1e-5 — and against a
    float64 top-k over its own scheduled leaves.  Fails the run on a
    miss."""
    lanes = differ = tied = dtw_lanes = 0
    gap = 0.0
    offset = 0
    for B in ladder:
        qb = qs[offset % len(qs):][:B].copy()
        if len(qb) < B:
            qb = np.concatenate([qb, qs[:B - len(qb)]])
        ks, nbrs, mets = serving_knobs(B, offset)
        for i, k in enumerate(ks):
            if k == 0:
                qb[i] = 0.0                      # a dead lane: finite pad
        ids, d, leaves = sd.bucket_search_device_batch(
            index, qb, ks, nbrs, mets, k_max=SERVE_K_MAX,
            nbr_max=SERVE_NBR_MAX, band=BAND, dev=dev)
        for i, (k, nbr, m) in enumerate(zip(ks, nbrs, mets)):
            if k == 0:
                if not ((ids[i] == -1).all() and np.isinf(d[i]).all()
                        and (leaves[i] == -1).all()):
                    fail(f"bucket {B}: dead lane {i} returned results")
                continue
            lanes += 1
            dtw_lanes += m == "dtw"
            a_ids, a_d, a_leaves = sd.extended_search_device_batch(
                index, qb[i:i + 1], k, nbr=nbr, metric=m, band=BAND,
                rerank=False, dev=dev)
            if not np.array_equal(leaves[i, :nbr], a_leaves[0][:nbr]):
                fail(f"bucket {B} lane {i}: schedule differs from the "
                     f"request alone")
            if not ((leaves[i, nbr:] == -1).all() and (ids[i, k:] == -1).all()
                    and np.isinf(d[i, k:]).all()):
                fail(f"bucket {B} lane {i}: columns past k / nbr not padded")
            if not (np.array_equal(ids[i, :k], a_ids[0])
                    and np.array_equal(d[i, :k], a_d[0])):
                differ += 1
                ok, g = ties_only(np, ids[i:i + 1, :k], d[i:i + 1, :k],
                                  a_ids, a_d)
                gap = max(gap, g)
                if not ok:
                    fail(f"bucket {B} lane {i} ({m}): differs from the "
                         f"request alone beyond ties at rtol 1e-5 (max rel "
                         f"{g:.3e})")
            # float64 top-k over the lane's own scheduled leaves
            q32 = torch.from_numpy(qb[i:i + 1]).to(dev.db[0].device)
            rows_of = schedule_rows(torch, np, dev, leaves[i:i + 1, :nbr])
            if m == "ed":
                bd, bi = brute_force(torch, dev, q32, k, rows_of)
                dist = (lambda qi, j, q=qb[i]: np.sqrt(
                    ((db[j].astype(np.float64) - q.astype(np.float64))
                     ** 2).sum()))
            else:
                bd, bi, _ = dtw_float64_check(torch, dev, q32,
                                              d[i:i + 1, :k], BAND, k,
                                              rows_of)
                dist = lambda qi, j, q=qb[i]: dtw_np(q, db[j], BAND)
            tied += check_exact(np, ids[i:i + 1, :k], d[i:i + 1, :k],
                                bd.cpu().numpy(), bi.cpu().numpy(), dist, k)
        offset += B
    print(f"  bucket parity: buckets of {ladder} lanes (k 1..10, nbr "
          f"1..4, every fourth lane DTW band {BAND}, lane 1 dead from 4 "
          f"lanes up): {lanes} live lanes ({dtw_lanes} DTW), schedules "
          f"bitwise equal to each request alone; ids and distances differ "
          f"from the request alone in {differ} lanes (max rel gap "
          f"{gap:.3e}); every lane equal to the float64 top-k over its "
          f"scheduled leaves (tied positions {tied})")
    return dict(lanes=lanes, dtw_lanes=dtw_lanes, lanes_differing=differ,
                max_rel_gap=gap)


def serving_kernels(torch, np, sd, ops, ref, gather, index, dev, qs, floor,
                    clock_hz, smi, n_iter: int = 20) -> list:
    """Phase 10 (b): the five kernels as a bucket calls them, at B = 1 and
    B = 64 (mixed buckets, every fourth lane DTW): each recorded call
    against its plain version (``sax_encode`` and ``lb_paa_interval``
    bitwise against their in-order sums, ``dtw_band`` bitwise against its
    twin, the LB kernels within rtol 1e-5), its time beside its bound, and
    each kernel's launches a bucket (pure ED and mixed)."""
    out = []
    for B in (1, 64):
        qb = torch.from_numpy(qs[:B]).cuda()
        nbrs = np.full(B, SERVE_NBR_MAX)
        dtw = np.array([i % 4 == 3 for i in range(B)]) if B > 1 \
            else np.array([True])
        per_bucket = {}
        for label, lane_dtw in (("ED", np.zeros(B, bool)), ("mixed", dtw)):
            with recorded_calls(ops) as rec:
                sd.bucket_search_launch(index, qb, nbrs, lane_dtw,
                                        k_max=SERVE_K_MAX,
                                        nbr_max=SERVE_NBR_MAX, band=BAND,
                                        dev=dev)
                torch.cuda.synchronize()
            per_bucket[label] = dict(rec.count)
        print(f"  B={B}: launches a bucket, pure ED {per_bucket['ED']}; "
              f"mixed {per_bucket['mixed']}")
        calls = rec.calls
        for name in SERVING_KERNELS:
            for j, (a, kw) in enumerate(calls[name]):
                got = getattr(ops, name)(*a, **kw)
                torch.cuda.synchronize()
                if name == "sax_encode":
                    paa, sym = ref.sax_encode_in_order(*a)
                    ok = (torch.equal(got[0], paa)
                          and torch.equal(got[1].long(), sym))
                    x = a[0]
                    Bq, n, w = x.shape[0], x.shape[1], a[1]
                    b = bound(4 * (Bq * n + 2 * Bq * w + 255),
                              Bq * n + Bq * w + Bq * w * 8)
                    what = f"[{Bq},{n}]"
                elif name == "lb_paa_interval":
                    ok = torch.equal(got, ref.lb_paa_interval_in_order(*a))
                    Q, w = a[0].shape
                    Lt = a[2].shape[0]
                    b = bound(4 * (2 * Q * w + 2 * Lt * w + Q * Lt),
                              7 * Q * Lt * w + Q * Lt)
                    what = (f"[{Q},{Lt},{w}] "
                            f"{'leaves' if j == 0 else 'routing edges'}")
                elif name == "dtw_band":
                    q, cand, mask, cut, r = a
                    want, b_ms, b_by, chain = dtw_call_work(
                        torch, gather, q, cand, mask, cut, r, None, clock_hz)
                    ok = (torch.equal(torch.isinf(got), torch.isinf(want))
                          and torch.equal(got, want))
                    b = (b_ms, b_by)
                    cutoff = ("no cutoff" if bool(torch.isinf(cut).all())
                              else "cutoff")
                    what = (f"per query [{q.shape[0]},{cand.shape[1]}] rank "
                            f"{j} ({cutoff}, {int(mask.sum())} lanes on)")
                    del want
                else:
                    want = getattr(ref, f"{name}_ref")(*a)
                    ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5)
                              and not torch.isnan(got).any())
                    x = a[0]
                    Q, m, n = x.shape
                    el = Q * m * n
                    n_env = 2 if name == "lb_keogh" else 3
                    per = LBK_OPS if name == "lb_keogh" else LBI_OPS
                    b = bound(4 * (el + n_env * Q * n + Q * m), per * el)
                    what = f"per query [{Q},{m},{n}] rank {j}"
                    del want
                if not ok:
                    fail(f"{name} disagrees with its plain version at a "
                         f"B={B} bucket's call {what}")
                ms, host = time_ms(torch, getattr(ops, name),
                                   [a] * (5 if name == "dtw_band" else n_iter))
                print(f"    {name} {what}: agrees with its plain version; "
                      f"kernel {ms:.5f} ms (host {host:.4f} ms per call; "
                      f"launch floor {floor:.5f} ms), bound {b[0]:.6f} ms "
                      f"({b[1]}) [{smi}]")
                out.append(dict(name=name, B=B, call=what, ms=ms,
                                bound_ms=b[0], bound_by=b[1],
                                launches_ed=per_bucket["ED"][name],
                                launches_mixed=per_bucket["mixed"][name]))
        del calls, rec
    return out


def launch_without_wait(torch, np, sd, index, dev, qs, smi) -> list:
    """Phase 10 (c): ``bucket_search_launch`` under
    ``torch.cuda.set_sync_debug_mode("error")`` (a device→host wait inside
    it raises) while the stream is held by ``torch.cuda._sleep``: the
    launch must return before the held stream reaches its first kernel.
    Prints the launch's host µs against the bucket's device ms."""
    out = []
    for B in (1, 64):
        qb = torch.from_numpy(qs[:B]).cuda()
        nbrs = np.full(B, SERVE_NBR_MAX)
        for label, lane_dtw in (
                ("ED", np.zeros(B, bool)),
                ("mixed", np.array([i % 4 == 3 for i in range(B)])
                 if B > 1 else np.array([True]))):
            kw = dict(k_max=SERVE_K_MAX, nbr_max=SERVE_NBR_MAX, band=BAND,
                      dev=dev)
            sd.bucket_search_launch(index, qb, nbrs, lane_dtw, **kw)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(400_000_000)
            start.record()
            torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            try:
                sd.bucket_search_launch(index, qb, nbrs, lane_dtw, **kw)
            except RuntimeError as e:
                fail(f"a B={B} {label} bucket launch waits for the device: "
                     f"{e}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            host_us = (time.perf_counter() - t0) * 1e6
            held = not start.query()
            end.record()
            torch.cuda.synchronize()
            dev_ms = start.elapsed_time(end)
            if not held:
                fail(f"a B={B} {label} bucket launch returned only after "
                     f"the held stream ran ({host_us:.1f} us)")
            print(f"  B={B} {label} bucket: launch under "
                  f"set_sync_debug_mode('error') returned in {host_us:.1f} "
                  f"us of host time while the stream was still held; the "
                  f"bucket's device time {dev_ms:.4f} ms [{smi}]")
            out.append(dict(B=B, bucket=label, launch_host_us=host_us,
                            device_ms=dev_ms))
    return out


def open_loop(np, fe, pool, rate: float, n_req: int, mix, seed: int,
              stats_cls) -> dict:
    """Drive one Poisson arrival schedule through ``fe`` (the load
    generator of ``benchmarks/bench_serving.py``): latency is ``t_done -
    scheduled arrival``, so a slow server cannot slow the clock down.
    Fails the run if any request fails."""
    fe.stats = stats_cls()
    rng = np.random.default_rng(seed)
    # lint: allow-timing: an arrival schedule; latency ends at t_done
    sched = time.perf_counter() + 0.005 + np.cumsum(
        rng.exponential(1.0 / rate, size=n_req))
    futs = []
    for i in range(n_req):
        now = time.perf_counter()
        if sched[i] > now:
            time.sleep(sched[i] - now)
        k, nbr, met = mix[i % len(mix)]
        futs.append(fe.submit(pool[i % len(pool)], k=k, nbr=nbr, metric=met))
    lat = np.empty(n_req)
    t_last = 0.0
    for i, f in enumerate(futs):
        try:
            r = f.result(timeout=300)
        except Exception as e:                 # noqa: BLE001 - fail the run
            fail(f"open-loop request {i} at {rate:.1f} req/s failed: {e!r}")
        lat[i] = r.t_done - sched[i]
        t_last = max(t_last, r.t_done)
    s = fe.stats
    if s.failed:
        fail(f"{s.failed} requests failed at {rate:.1f} req/s")
    return {"offered_qps": rate, "n_requests": n_req,
            "sustained_qps": n_req / (t_last - sched[0]),
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "p999_ms": float(np.percentile(lat, 99.9) * 1e3),
            "mean_ms": float(lat.mean() * 1e3),
            "padding_waste": s.padding_waste,
            "mean_occupancy": s.mean_occupancy, "batches": s.batches,
            "occupancy": {str(b): c for b, c in sorted(s.occupancy.items())}}


def closed_loop_qps(np, fn, batches) -> float:
    """Median queries/s of whole passes over ``batches`` (at least
    ``QPS_MIN_PASSES`` passes and ``QPS_WINDOW_S`` seconds), as phase 9
    times its configurations."""
    fn(batches[0])
    # lint: allow-timing: fn returns host arrays (synced)
    rates, t1 = [], time.perf_counter()
    while (len(rates) < QPS_MIN_PASSES
           or time.perf_counter() - t1 < QPS_WINDOW_S):
        t2 = time.perf_counter()
        for qb in batches:
            fn(qb)
        rates.append(sum(len(qb) for qb in batches)
                     / (time.perf_counter() - t2))
    return float(np.median(rates))


def open_loop_load(torch, np, sd, mods, frontend_cls, stats_cls, index, dev,
                   qs, batches, paths, smi) -> dict:
    """Phase 10 (d): open-loop Poisson load through a ``CoalescingFrontend``
    (``max_batch`` 64, ``max_wait`` 2 ms): ED at 0.25, 0.6, 1.0 and 1.4 x
    the closed-loop ED extended nbr=4 ``rerank=False`` batch-64 rate
    (phase 9, this run), then a 25%-DTW mix at half the closed-loop rate of
    25%-DTW buckets (measured here).  A NaN request first: it fails its own
    future with the individual path's error, its neighbours complete.  The
    kernel counts are zeroed before the load and read after it; every one
    of the five serving kernels must have run.  Fails the run if a request
    fails or the mean occupancy at the top rate is not above 1."""
    closed = next(x["qps"] for x in paths
                  if (x["metric"], x["path"], x["nbr"], x["rerank"])
                  == ("ED", "extended", SERVE_NBR_MAX, False))
    # lint: allow-timing: set-up seconds; the load's times end at t_done
    t1 = time.perf_counter()
    fe = frontend_cls(index, k_max=SERVE_K_MAX, nbr_max=SERVE_NBR_MAX,
                      max_batch=SERVE_MAX_BATCH, max_wait=SERVE_MAX_WAIT,
                      band=BAND, dev=dev)
    print(f"  front-end built and warmed ({len(fe.buckets)} bucket sizes x "
          f"pure ED and mixed): {time.perf_counter() - t1:.3f} s")
    out = {"closed_loop_qps": closed}
    try:
        # -- a NaN lane through the front-end --------------------------------
        bad = qs[0].copy()
        bad[7] = np.nan
        fe.max_wait = 0.2                  # coalesce the three into one
        f_ok1 = fe.submit(qs[1], k=3, nbr=2)
        f_bad = fe.submit(bad, k=3, nbr=2)
        f_ok2 = fe.submit(qs[2], k=5, nbr=4, metric="dtw")
        try:
            f_bad.result(timeout=60)
            fail("the NaN request completed")
        except ValueError as e:
            got_msg = str(e)
        r1, r2 = f_ok1.result(timeout=60), f_ok2.result(timeout=60)
        fe.max_wait = SERVE_MAX_WAIT
        try:
            sd.extended_search_device_batch(index, bad[None], 3, nbr=2,
                                            rerank=False, dev=dev)
            fail("the individual path accepted a NaN query")
        except ValueError as e:
            want_msg = str(e)
        if got_msg != want_msg:
            fail(f"the NaN lane's error {got_msg!r} is not the individual "
                 f"path's {want_msg!r}")
        for r, q, k, nbr, m in ((r1, qs[1], 3, 2, "ed"),
                                (r2, qs[2], 5, 4, "dtw")):
            a = sd.extended_search_device_batch(
                index, q[None], k, nbr=nbr, metric=m, band=BAND,
                rerank=False, dev=dev)
            ok, _ = ties_only(np, r.ids[None], r.d[None], a[0], a[1])
            if not (ok and np.array_equal(r.leaves, a[2][0][:nbr])):
                fail(f"a neighbour of the NaN lane ({m}) differs from the "
                     f"request alone")
        print(f"  NaN lane: failed its own future with {got_msg!r} (the "
              f"individual path's message); its two neighbours (ED, DTW) "
              f"equal their requests alone")

        # -- ED at fractions of the closed-loop rate --------------------------
        for m in mods.values():
            m.launches = 0
        ed_mix = [(k, nbr, "ed") for k, nbr in KNOB_MIX]
        out["rates"] = {}
        for i, frac in enumerate(RATE_FRACS):
            rate = frac * closed
            rec = open_loop(np, fe, qs, rate, max(200, int(rate * LOAD_S)),
                            ed_mix, seed=100 + i, stats_cls=stats_cls)
            out["rates"][str(frac)] = rec
            print(f"  ED open loop {frac} x {closed:.2f} = {rate:.2f} req/s "
                  f"offered: sustained {rec['sustained_qps']:.2f}, latency "
                  f"p50 {rec['p50_ms']:.3f} / p99 {rec['p99_ms']:.3f} / "
                  f"p99.9 {rec['p999_ms']:.3f} ms, mean occupancy "
                  f"{rec['mean_occupancy']:.3f}, padding waste "
                  f"{rec['padding_waste']:.4f}, {rec['batches']} buckets, "
                  f"occupancy {rec['occupancy']} [{smi}]")
        top = out["rates"][str(RATE_FRACS[-1])]
        if top["mean_occupancy"] <= 1.0:
            fail(f"no coalescing at the top rate: mean occupancy "
                 f"{top['mean_occupancy']}")

        # -- 25% DTW at half the closed-loop rate of mixed buckets ------------
        dtw_mix = [(k, nbr, "dtw" if i % 4 == 3 else "ed")
                   for i, (k, nbr) in enumerate(KNOB_MIX * 2)]
        lanes = [dtw_mix[i % len(dtw_mix)] for i in range(BATCH)]
        ks, nbrs, mets = ([x[j] for x in lanes] for j in range(3))
        mixed = closed_loop_qps(np, lambda qb: sd.bucket_search_device_batch(
            index, qb, ks, nbrs, mets, k_max=SERVE_K_MAX,
            nbr_max=SERVE_NBR_MAX, band=BAND, dev=dev), batches)
        rate = DTW_MIX_FRAC * mixed
        rec = open_loop(np, fe, qs, rate, max(200, int(rate * LOAD_S)),
                        dtw_mix, seed=200, stats_cls=stats_cls)
        out["closed_loop_mixed_qps"] = mixed
        out["dtw_mix"] = rec
        print(f"  closed loop, 64-lane buckets with every fourth lane DTW: "
              f"{mixed:.2f} queries/s; open loop at {DTW_MIX_FRAC} x = "
              f"{rate:.2f} req/s: sustained {rec['sustained_qps']:.2f}, "
              f"p50 {rec['p50_ms']:.3f} / p99 {rec['p99_ms']:.3f} / p99.9 "
              f"{rec['p999_ms']:.3f} ms, mean occupancy "
              f"{rec['mean_occupancy']:.3f}, padding waste "
              f"{rec['padding_waste']:.4f}, occupancy {rec['occupancy']} "
              f"[{smi}]")
        launches = {name: m.launches for name, m in mods.items()}
    finally:
        fe.close(timeout=120)
    print(f"  launches on the serving path (open loop, both mixes): "
          f"{launches}")
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the serving path")
    out["launches"] = launches
    return out


def knn_softmax_phase(torch, np, sd, hs, head_cls, seed: int) -> dict:
    """Phase 10 (e): the kNN-softmax head at OLMo-1B width
    (``lm_head [2048, 50 304]``, normal / sqrt(d), from ``seed``; 64 hidden
    states ``lm_head[:, t] + 0.3 noise`` with noise of a column's scale):
    ``step_batch_via`` through a front-end gives exactly ``step_batch``'s
    tokens, and for 8 states the batched candidates equal the host
    ``candidates`` up to ties at rtol 1e-5.  Prints the build seconds,
    decode tokens/s of both paths and the recall stats."""
    rng = np.random.default_rng(seed)
    t1 = time.perf_counter()
    lm_head = (rng.standard_normal((OLMO_D, OLMO_VOCAB), dtype=np.float32)
               / np.float32(np.sqrt(OLMO_D)))
    tgt = rng.integers(OLMO_VOCAB, size=BATCH)
    H = (lm_head[:, tgt].T + 0.3 * rng.standard_normal(
        (BATCH, OLMO_D), dtype=np.float32) / np.float32(np.sqrt(OLMO_D))
         ).astype(np.float32)
    t_data = time.perf_counter() - t1
    t1 = time.perf_counter()
    head = head_cls(lm_head, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t1
    dev = head.index.device_index(device="cuda")
    print(f"  head: lm_head [{OLMO_D}, {OLMO_VOCAB}] ({t_data:.3f} s to "
          f"make), index over {OLMO_VOCAB} rows of {dev.n} floats: "
          f"{dev.n_leaves} leaves, lmax {dev.lmax}; build and upload "
          f"{t_build:.3f} s; r {head.r}, nbr {head.nbr}")
    direct = head.step_batch(H)                           # stats tracked
    s = head.stats
    t1 = time.perf_counter()
    with head.make_frontend(max_batch=BATCH, max_wait=SERVE_MAX_WAIT) as fe:
        t_fe = time.perf_counter() - t1
        via = head.step_batch_via(fe, H, track_exact=False)
        if not np.array_equal(via, direct):
            fail(f"step_batch_via's tokens differ from step_batch's in "
                 f"{int((via != direct).sum())} of {BATCH} rows")
        times_via = []
        for _ in range(3):
            t1 = time.perf_counter()
            head.step_batch_via(fe, H, track_exact=False)
            times_via.append(time.perf_counter() - t1)
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        head.step_batch(H, track_exact=False)
        times.append(time.perf_counter() - t1)
    # 8 states: the batched candidates against the host's, ties only
    enc = head._encode_queries(H[:8])
    cand = head.candidates_batch(H[:8])
    ids, d, _ = sd.extended_search_device_batch(
        head.index, enc, head.r, nbr=head.nbr, rerank=False, dev=dev,
        metric=head.metric)
    if not np.array_equal(cand, ids):
        fail("candidates_batch differs from its extended search")
    same = 0
    for i, h in enumerate(H[:8]):
        # the host search on the batch's encoding (``candidates`` encodes
        # one state in float64, ``_encode_queries`` a batch in float32, as
        # the reference does; the two can differ in a last bit)
        h_ids, h_d, _ = hs.extended_search(head.index, enc[i], head.r,
                                           head.nbr, metric=head.metric)
        same += bool(np.array_equal(head.candidates(h), h_ids))
        m = len(h_ids)
        ok, gap = ties_only(np, ids[i:i + 1, :m], d[i:i + 1, :m],
                            h_ids[None], h_d[None].astype(np.float32))
        if not (ok and (ids[i, m:] == -1).all()):
            fail(f"state {i}: batched candidates differ from the host's "
                 f"beyond ties at rtol 1e-5 (max rel {gap:.3e})")
    tok_s = BATCH / float(np.median(times))
    tok_s_via = BATCH / float(np.median(times_via))
    print(f"  step_batch_via through a front-end (built and warmed in "
          f"{t_fe:.3f} s) gives step_batch's {BATCH} tokens exactly; for 8 "
          f"states the batched candidates equal the host extended search's "
          f"on the same encoding up to ties at rtol 1e-5 (the host "
          f"candidates() of its own encoding identical in {same} of 8)")
    print(f"  decode: step_batch {tok_s:.2f} tokens/s, step_batch_via "
          f"{tok_s_via:.2f} tokens/s (batch {BATCH}, without the exact "
          f"logits); exact_in_topr / tokens {s.exact_in_topr}/{s.tokens} = "
          f"{s.exact_in_topr / s.tokens:.4f}, agree_argmax / tokens "
          f"{s.agree_argmax}/{s.tokens} = {s.agree_argmax / s.tokens:.4f}")
    return dict(build_s=t_build, leaves=dev.n_leaves, lmax=dev.lmax,
                tokens_per_s=tok_s, tokens_per_s_via=tok_s_via,
                exact_in_topr=s.exact_in_topr / s.tokens,
                agree_argmax=s.agree_argmax / s.tokens)


def serving_phase(torch, np, sd, hs, ops, ref, gather, dtw_np, mods,
                  frontend_cls, stats_cls, head_cls, index, dev, db, qs,
                  batches, paths, floor, clock_hz, smi, seed) -> dict:
    """Phase 10: serving on the main path's ``DeviceIndex`` (no second
    layout), parts (a)–(e), each printed with its seconds."""
    builds = index._n_device_builds
    out = {}
    for part, fn in (
            ("a", lambda: bucket_parity(torch, np, sd, dtw_np, index, dev,
                                        db, qs)),
            ("b", lambda: serving_kernels(torch, np, sd, ops, ref, gather,
                                          index, dev, qs, floor, clock_hz,
                                          smi)),
            ("c", lambda: launch_without_wait(torch, np, sd, index, dev, qs,
                                              smi)),
            ("d", lambda: open_loop_load(torch, np, sd, mods, frontend_cls,
                                         stats_cls, index, dev, qs, batches,
                                         paths, smi)),
            ("e", lambda: knn_softmax_phase(torch, np, sd, hs, head_cls,
                                            seed + 1))):
        # lint: allow-timing: each part ends on host results (synced)
        t1 = time.perf_counter()
        out[part] = fn()
        print(f"  [10{part}] {time.perf_counter() - t1:.3f} s")
    if index._n_device_builds != builds:
        fail("phase 10 built another DeviceIndex layout")
    print("  no DeviceIndex layout built for the main index by phase 10")
    return out


def layout_mismatch(np, a, b) -> str | None:
    """The first layout field where two indexes differ: the leaf layout,
    every routing array of ``tests/test_build_pipeline.py`` and the stats
    (``plans_evaluated`` apart: the backends count plans per row and per
    word group).  ``None`` where they agree bitwise."""
    for f in ("order", "leaf_offsets", "leaf_sym", "leaf_card"):
        if not np.array_equal(getattr(a.flat, f), getattr(b.flat, f)):
            return f
    ra, rb = a.routing_flat, b.routing_flat
    for f in ROUTING_FIELDS:
        if not np.array_equal(getattr(ra, f), getattr(rb, f)):
            return f
    sa, sb = dict(vars(a.stats)), dict(vars(b.stats))
    sa.pop("plans_evaluated")
    sb.pop("plans_evaluated")
    return None if sa == sb else f"stats {sa} != {sb}"


def rows_outside_leaves(np, flat, sax, b: int) -> int:
    """Rows of the layout whose symbols (``sax``) fall outside their leaf's
    SAX region."""
    leaf = np.repeat(np.arange(flat.n_leaves), np.diff(flat.leaf_offsets))
    card = flat.leaf_card[leaf].astype(np.int64)
    prefix = sax[flat.order].astype(np.int64) >> (b - card)
    return int((prefix != flat.leaf_sym[leaf]).any(axis=1).sum())


def borderline_symbols(np, breakpoints, db, sax, sax_ref, w: int, b: int
                       ) -> float:
    """Symbols of ``sax`` (a float32 encoder's) that differ from ``sax_ref``
    (``sax_encode_np``'s, from float64 means) must be borderline: one
    breakpoint apart, with the segment's float64 mean within
    ``(m + 2)·2⁻²⁴·(mean|x| + |bp|)`` of that breakpoint ``bp`` — the error
    of any float32 sum of the m = n / w values plus the breakpoint's own
    float32 rounding.  Fails otherwise; returns the largest distance as a
    share of its bound (0 where no symbol differs)."""
    r, j = np.nonzero(sax != sax_ref)
    if len(r) == 0:
        return 0.0
    m = db.shape[1] // w
    seg = db[r].astype(np.float64).reshape(len(r), w, m)
    seg = seg[np.arange(len(r)), j]
    hi = np.maximum(sax[r, j], sax_ref[r, j]).astype(np.int64)
    if (hi - np.minimum(sax[r, j], sax_ref[r, j]) != 1).any():
        fail("a kernel symbol is more than one breakpoint from "
             "sax_encode_np's")
    bp = np.asarray(breakpoints(b), np.float64)[hi - 1]
    tol = (m + 2) * 2.0 ** -24 * (np.abs(seg).mean(axis=1) + np.abs(bp))
    share = np.abs(seg.mean(axis=1) - bp) / tol
    if (share > 1).any():
        k = int(share.argmax())
        fail(f"symbol ({r[k]}, {j[k]}) differs from sax_encode_np's with "
             f"its float64 mean {float(seg[k].mean())!r} {share[k]:.3f} "
             f"times the float32 gap from breakpoint {float(bp[k])!r}")
    return float(share.max())


def store_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def lifecycle_phase(torch, np, sd, ops, mods, DumpyIndex, device_build,
                    smoke, fp, breakpoints, random_walks, params, index, dev,
                    db, batches, exact_ed, host_build_s, seed) -> dict:
    """Phase 11: the index lifecycle on the main collection, parts (a)–(e),
    each printed with its seconds.  Every check fails the run on a miss;
    returns the ``{"lifecycle": ...}`` summary."""
    import shutil
    import tempfile
    out = {"host_build_s": host_build_s}
    w, b = params.sax.w, params.sax.b
    qb = batches[0]

    # -- (a) device build, sax_encode_np: the host build's layout bitwise ----
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    idx_np = DumpyIndex.build(db, params, backend="device", device="cuda")
    torch.cuda.synchronize()
    out["device_build_np_s"] = time.perf_counter() - t1
    bad = layout_mismatch(np, idx_np, index)
    if bad is not None:
        fail(f"device build (np encoder) differs from the host build: {bad}")
    t2 = time.perf_counter()
    dev_np = idx_np.device_index(chunk=CHUNK, device="cuda")
    torch.cuda.synchronize()
    if idx_np._db_ordered is not None:
        fail("device_index of the device build went through the host rows")
    for f in ("db", "ids", "leaf_start"):
        if not torch.equal(getattr(dev_np, f), getattr(dev, f)):
            fail(f"DeviceIndex from the device rows differs in {f}")
    print(f"  (a) device build (np encoder) {out['device_build_np_s']:.3f} s "
          f"against the host build's {host_build_s:.3f} s: layout, routing "
          f"and stats bitwise the host build's (plans evaluated "
          f"{idx_np.stats.plans_evaluated} / {index.stats.plans_evaluated}); "
          f"DeviceIndex from the rows on the device in "
          f"{time.perf_counter() - t2:.3f} s, db / ids / leaf_start bitwise "
          f"phase 3's")
    del idx_np, dev_np
    torch.cuda.empty_cache()

    # -- (b) device build, the sax_encode kernel -----------------------------
    t1 = time.perf_counter()
    x = torch.from_numpy(db).cuda()
    ms, _ = time_ms(torch, lambda t: ops.sax_encode(t, w, b), [(x,)] * 5,
                    warmup=1)
    B, n = x.shape
    bms, by = bound(B * n * 4 + B * w * 8, B * n)
    del x
    torch.cuda.empty_cache()
    for m in mods.values():
        m.launches = 0
    t2 = time.perf_counter()
    res = device_build(db, params, encoder="kernel", device="cuda")
    torch.cuda.synchronize()
    out["device_build_kernel_s"] = time.perf_counter() - t2
    kl = {name: m.launches for name, m in mods.items()}
    if kl["sax_encode"] <= 0:
        fail("the kernel-encoder device build launched no sax_encode")
    differ = int((res.sax != index.sax).sum())
    rows_differ = int((res.sax != index.sax).any(axis=1).sum())
    worst = borderline_symbols(np, breakpoints, db, res.sax, index.sax, w, b)
    outside = rows_outside_leaves(np, res.flat, res.sax, b)
    if outside:
        fail(f"{outside} rows lie outside their leaf's SAX region")
    idx_k = DumpyIndex.from_device_build(db, params, res)
    del res
    if differ == 0:
        bad = layout_mismatch(np, idx_k, index)
        if bad is not None:
            fail(f"kernel-encoder build differs from (a) with no symbol "
                 f"differing: {bad}")
    dev_k = idx_k.device_index(chunk=CHUNK, device="cuda")
    ids, d, _ = sd.exact_search_device_batch(idx_k, qb, K, dev=dev_k)
    bd, bi = brute_force(torch, dev_k, torch.from_numpy(qb).cuda(), K)
    tied = check_exact(
        np, ids, d, bd.cpu().numpy(), bi.cpu().numpy(),
        lambda qi, i: np.sqrt(((db[i].astype(np.float64)
                                - qb[qi].astype(np.float64)) ** 2).sum()), K)
    out.update(sax_encode_ms=ms, sax_encode_bound_ms=bms,
               sax_encode_bound_by=by, symbols_differ=differ,
               rows_differ=rows_differ, symbols_differ_worst_share=worst,
               kernel_layout_equal=differ == 0,
               kernel_build_launches=kl, kernel_leaves=idx_k.flat.n_leaves)
    print(f"  (b) sax_encode over [{B}, {n}]: {ms:.5f} ms on the card "
          f"(bound {bms:.6f} ms, {by}); device build (kernel encoder) "
          f"{out['device_build_kernel_s']:.3f} s, launches {kl}; "
          f"{differ} symbols in {rows_differ} rows differ from "
          f"sax_encode_np, each one breakpoint apart and borderline (the "
          f"farthest float64 mean at {worst:.3f} of its float32 gap); every "
          f"row inside its leaf's region; "
          f"{idx_k.flat.n_leaves} leaves ({index.flat.n_leaves} on the host"
          f"); layout {'equal to' if differ == 0 else 'not compared with'} "
          f"(a)'s; batch 0 exact against the float64 brute force (tied "
          f"{tied}) ({time.perf_counter() - t1:.3f} s)")
    del idx_k, dev_k
    torch.cuda.empty_cache()

    # -- (c) save and load ---------------------------------------------------
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    df = subprocess.run(["df", "-h", str(build_dir)], capture_output=True,
                        text=True, timeout=60).stdout.strip()
    print("  " + df.replace("\n", "\n  "))
    per_row = db.shape[1] * 4 + w * 5 + 1 + 8
    free = shutil.disk_usage(build_dir).free
    # two generations (the crashed overwrite renames its own into place)
    # and the write-ahead log, with a tenth to spare
    n_save = min(db.shape[0], SAVE_ROWS)
    if free < 2.2 * n_save * per_row:
        fail(f"{free} bytes free under build/ hold no two generations of "
             f"{n_save} rows")
    out["saved_rows"] = n_save
    if n_save == db.shape[0]:
        saved, want_ids, want_d = index, exact_ed[0][0], exact_ed[0][1]
    else:
        saved = DumpyIndex.build(db[:n_save], params)
        want_ids, want_d, _ = sd.exact_search_device_batch(saved, qb, K,
                                                           chunk=CHUNK)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path = str(Path(tmp) / "idx")
        t1 = time.perf_counter()
        saved.save(path)
        out["save_s"] = time.perf_counter() - t1
        out["save_gb"] = store_bytes(Path(path)) / 1e9
        t1 = time.perf_counter()
        re = DumpyIndex.load(path)
        out["load_s"] = time.perf_counter() - t1
        if re._dirty or re._device_cache or re._n_device_builds:
            fail("a loaded index is not clean")
        if not (np.array_equal(re.db, saved.db)
                and np.array_equal(re.alive, saved.alive)
                and np.array_equal(re.flat.order, saved.flat.order)):
            fail("the loaded index differs from the saved one")
        for m in mods.values():
            m.launches = 0
        t1 = time.perf_counter()
        ids, d, _ = sd.exact_search_device_batch(re, qb, K, chunk=CHUNK)
        out["loaded_search_s"] = time.perf_counter() - t1
        ll = {name: m.launches for name, m in mods.items()}
        for name in ("sax_encode", "lb_paa_interval", "pairwise_l2"):
            if ll[name] <= 0:
                fail(f"kernel {name} was not launched on the loaded index")
        if not (np.array_equal(ids, want_ids) and np.array_equal(d, want_d)):
            fail("exact ED on the loaded index differs from before the save")
        out["loaded_search_launches"] = ll
        print(f"  (c) saved {n_save} series in {out['save_s']:.3f} s "
              f"({out['save_gb']:.3f} GB with sha256), loaded and verified "
              f"in {out['load_s']:.3f} s; batch 0 exact ED on the loaded "
              f"index bitwise equal to before the save "
              f"({out['loaded_search_s']:.3f} s with its DeviceIndex "
              f"upload), launches {ll}")

        # -- (d) crash at the commit, then WAL replay -------------------------
        new = random_walks(1000, db.shape[1], seed=seed + 7)
        t1 = time.perf_counter()
        new_ids = re.insert_many(new)
        out["insert_s"] = time.perf_counter() - t1
        crashed = False
        t1 = time.perf_counter()
        try:
            with fp.armed({"index.save.commit": "crash"}):
                re.save(path)
        except fp.InjectedCrash:
            crashed = True
        out["crashed_save_s"] = time.perf_counter() - t1
        if not crashed:
            fail("the save did not crash at index.save.commit")
        t1 = time.perf_counter()
        back = DumpyIndex.load(path)
        out["recover_s"] = time.perf_counter() - t1
        if not (np.array_equal(back.db, re.db)
                and np.array_equal(back.alive, re.alive)):
            fail("the recovered index differs from the pre-crash one")
        del re
        torch.cuda.empty_cache()
        ids, d, _ = sd.exact_search_device_batch(back, new[:8].copy(), K,
                                                 chunk=CHUNK)
        if not (np.array_equal(ids[:, 0], new_ids[:8])
                and (d[:, 0] == 0).all()):
            fail(f"the recovered inserts are not found at distance 0: "
                 f"{ids[:, 0]} {d[:, 0]}")
        out["wal_rows"] = int(new.shape[0])
        print(f"  (d) insert_many of {new.shape[0]} series (WAL) "
              f"{out['insert_s']:.3f} s; save crashed at index.save.commit "
              f"after {out['crashed_save_s']:.3f} s; load with the WAL "
              f"replay {out['recover_s']:.3f} s: db and alive equal the "
              f"pre-crash index ({back.db.shape[0]} rows), 8 inserted "
              f"series found at distance 0")
        del back
        torch.cuda.empty_cache()

    # -- (e) the robustness smoke on the card --------------------------------
    t1 = time.perf_counter()
    if not (smoke.crash_on_commit_smoke(device="cuda")
            and smoke.degraded_search_smoke(device="cuda")):
        fail("the robustness smoke failed on the card")
    out["smoke_s"] = time.perf_counter() - t1
    print(f"  (e) robustness smoke on the card passed "
          f"({out['smoke_s']:.3f} s)")
    return out


def next_bit_hist(np, sax, w: int, b: int):
    """The root histogram recounted on the host: ``np.bincount`` of every
    row's first bit of each segment, segment 0 the most significant."""
    bits = (sax.astype(np.int64) >> (b - 1)) & 1
    codes = (bits << np.arange(w - 1, -1, -1)).sum(axis=1)
    return np.bincount(codes, minlength=1 << w)


def step_against_exact(np, db, qb, ids, d, ex_ids, ex_d) -> tuple:
    """Hold ``search_step``'s ``[Q, k]`` answer (``d`` from the one-pass
    ``|q|² + |x|² - 2 q·x`` form, as the reference's ``search_step``
    computes it) against the exact answer ``ex_ids / ex_d``: each d² within
    1e-5·(|q|² + |x|²) of the float64 d² of its id (the rounding bound of
    that form, ``pairwise_l2``'s tolerance), and each position's float64 d²
    within twice that of the exact one (ids swap only inside the rounding).
    Fails the run on a miss; returns the number of ids that differ."""
    q = qb.astype(np.float64)
    x = db[ids].astype(np.float64)                            # [Q, k, n]
    true2 = ((x - q[:, None, :]) ** 2).sum(-1)
    scale = (q * q).sum(-1)[:, None] + (x * x).sum(-1)
    if not (np.abs(d.astype(np.float64) ** 2 - true2) <= 1e-5 * scale).all():
        fail("search_step's d² is not within 1e-5·(|q|² + |x|²) of float64")
    if not (np.abs(true2 - ex_d.astype(np.float64) ** 2)
            <= 2e-5 * scale).all():
        fail("search_step's ids are not the exact top-k up to rounding")
    return int((ids != ex_ids).sum())


def sync_mesh(torch, mesh) -> None:
    """Wait for every card of ``mesh``: ``torch.cuda.synchronize()`` alone
    waits for the current card."""
    for d in mesh.distinct:
        torch.cuda.synchronize(d)


def cross_card_mesh(torch, sharding):
    """Four shards over every visible card (``cuda:s % cards``), or
    ``None`` on one card: four shards, so each answer is bitwise the
    ``[cuda:0] x 4`` one, the degraded one included."""
    cards = torch.cuda.device_count()
    if cards < 2:
        return None
    return sharding.make_mesh([f"cuda:{s % cards}" for s in range(4)])


def distributed_phase(torch, np, sd, ops, ref, mods, dist, sharding,
                      breakpoints, params, index, dev, db, batches,
                      dtw_batches, exact_ed, exact_dtw, paths_b0, lifecycle,
                      floor, smi) -> tuple[dict, dict]:
    """Phase 12 (a)–(c): ``build_distributed``, ``search_distributed`` on
    meshes of one and four entries against earlier phases' results, and
    ``search_step`` over the whole collection.  Every check fails the run
    on a miss; returns ``(summary, kernel rows at the new shape)``."""
    out = {}
    w, b = params.sax.w, params.sax.b
    N, n = db.shape
    qb = batches[0]
    q32 = torch.from_numpy(qb).cuda()
    mesh1 = sharding.make_mesh(["cuda:0"])
    mesh4 = sharding.make_mesh(["cuda:0"] * 4)

    # -- (a) build_distributed: the kernel's table, the summed histogram -----
    meshc = cross_card_mesh(torch, sharding)
    sync_mesh(torch, mesh1)
    t1 = time.perf_counter()
    for m in mods.values():
        m.launches = 0
    idx_d = dist.build_distributed(db, params, mesh=mesh1)
    sync_mesh(torch, mesh1)
    out["build_s"] = time.perf_counter() - t1
    la = {name: m.launches for name, m in mods.items()}
    if la["sax_encode"] <= 0:
        fail("build_distributed launched no sax_encode")
    ids0 = dev.ids[0][:N].long()
    paa_k, sax_k = ops.sax_encode(dev.db[0][:N], w, b)      # row order: ids0
    paa_o = torch.empty_like(paa_k)
    sax_o = torch.empty_like(sax_k)
    paa_o[ids0], sax_o[ids0] = paa_k, sax_k
    if not (torch.equal(torch.from_numpy(idx_d.paa).cuda(), paa_o)
            and torch.equal(torch.from_numpy(idx_d.sax).cuda().int(),
                            sax_o)):
        fail("build_distributed's table differs from sax_encode over the "
             "same rows")
    del paa_k, sax_k, paa_o, sax_o
    differ = int((idx_d.sax != index.sax).sum())
    worst = borderline_symbols(np, breakpoints, db, idx_d.sax, index.sax,
                               w, b)
    outside = rows_outside_leaves(np, idx_d.flat, idx_d.sax, b)
    if outside:
        fail(f"{outside} rows of the distributed build lie outside their "
             f"leaf's SAX region")
    leaves = idx_d.flat.n_leaves
    if leaves != lifecycle["kernel_leaves"]:
        fail(f"build_distributed gives {leaves} leaves, the kernel-encoder "
             f"device build {lifecycle['kernel_leaves']}")
    encodes = {}
    for label, mesh in (("[cuda:0] x 4", mesh4), ("cards", meshc)):
        if mesh is None:
            continue
        sync_mesh(torch, mesh)
        t2 = time.perf_counter()
        paa4, sax4, hist = dist.encode_distributed(db, w, b, mesh=mesh)
        sync_mesh(torch, mesh)
        encodes[label] = time.perf_counter() - t2
        hist = hist.cpu().numpy()
        if not (np.array_equal(paa4, idx_d.paa)
                and np.array_equal(sax4, idx_d.sax)):
            fail(f"the table of four row shards on {label} differs from "
                 f"one shard's")
        if int(hist.sum()) != N or not np.array_equal(
                hist, next_bit_hist(np, idx_d.sax, w, b)):
            fail(f"the summed histogram on {label} is not the bincount of "
                 f"the next-bit codes")
        del paa4, sax4
    enc4_s = encodes["[cuda:0] x 4"]
    out.update(launches_build=la, symbols_differ=differ,
               symbols_differ_worst_share=worst, leaves=leaves,
               height=idx_d.stats.height, encode_4_shards_s=enc4_s,
               hist_nonzero=int((hist > 0).sum()))
    print(f"  (a) build_distributed on mesh [cuda:0]: {out['build_s']:.3f} s "
          f"(phase 11: host build {lifecycle['host_build_s']:.3f} s, device "
          f"build {lifecycle['device_build_np_s']:.3f} s with sax_encode_np "
          f"and {lifecycle['device_build_kernel_s']:.3f} s with the kernel),"
          f" launches {la}; the table bitwise sax_encode over the same rows;"
          f" {differ} symbols differ from sax_encode_np, each borderline "
          f"(farthest at {worst:.3f} of its float32 gap); {leaves} leaves, "
          f"height {idx_d.stats.height}, every row inside its leaf; four "
          f"row shards (seconds {encodes}) give the same table and a "
          f"histogram summing to {int(hist.sum())} ({out['hist_nonzero']} "
          f"of {1 << w} codes used) equal to the host bincount [{smi}]")
    out["encode_s"] = encodes
    del idx_d
    torch.cuda.empty_cache()

    # -- (b) search_distributed against phases 5, 7 and 9 --------------------
    def same(got, want, what):
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            fail(f"{what} differs from the earlier result")

    for m in mods.values():
        m.launches = 0
    sync_mesh(torch, mesh1)
    t1 = time.perf_counter()
    same(dist.search_distributed(index, qb, K, mesh=mesh1), exact_ed[0][:2],
         "exact ED on the mesh [cuda:0]")
    sync_mesh(torch, mesh1)
    t_m1 = time.perf_counter() - t1
    for key in [k for k in index._device_cache if k[3] is mesh1]:
        del index._device_cache[key]           # free that layout's 4 GB
    torch.cuda.empty_cache()
    health = (True, True, True, False)

    def mesh_paths(mesh):
        """Each path of (b) on ``mesh``: its label, its call, the earlier
        phase's answer it must equal (``None``: the degraded run, held
        below)."""
        return (
            ("exact ED", lambda: dist.search_distributed(
                index, qb, K, mesh=mesh), exact_ed[0][:2]),
            ("extended ED nbr=4 rerank", lambda: dist.search_distributed(
                index, qb, K, nbr=4, mesh=mesh),
             paths_b0[("ED", "extended", 4, True)][:2]),
            ("approximate ED nbr=4", lambda: sd.approximate_search_device_batch(
                index, qb, K, nbr=4,
                dev=index.device_index(chunk=CHUNK, mesh=mesh)),
             paths_b0[("ED", "approximate", 4, None)]),
            ("exact DTW band 25 cluster", lambda: dist.search_distributed(
                index, dtw_batches[0], K, metric="dtw", band=BAND,
                mesh=mesh), exact_dtw[0][:2]),
            ("degraded exact ED", lambda: dist.search_distributed(
                index, qb, K, shard_health=health, mesh=mesh), None))

    def run_paths(mesh, label):
        seconds, got = {}, {}
        for name, fn, want in mesh_paths(mesh):
            sync_mesh(torch, mesh)
            t2 = time.perf_counter()
            got[name] = fn()
            for dv in mesh.distinct:            # every card of the mesh
                torch.cuda.synchronize(dv)
            seconds[name] = time.perf_counter() - t2
            if want is not None:
                same(got[name], want, f"{name} on the mesh {label}")
        return seconds, got

    times, got4 = run_paths(mesh4, "[cuda:0] x 4")
    dev4 = index.device_index(chunk=CHUNK, mesh=mesh4)
    if not (isinstance(dev4.db, tuple) and dev4.n_shards == 4):
        fail("the four-entry mesh did not place four shards")
    ids, d, cov = got4["degraded exact ED"]
    want_cov = sd.shard_coverage(index, dev4.with_shard_health(health))
    if cov != want_cov or not 0.0 < cov < 1.0:
        fail(f"degraded coverage {cov} != shard_coverage {want_cov}")
    live = torch.zeros(dev.db[0].shape[0], dtype=torch.bool, device="cuda")
    live[:dev4.row_bounds[3]] = True
    bd, bi = brute_force(torch, dev, q32, K, live=live)
    tied = check_exact(
        np, ids, d, bd.cpu().numpy(), bi.cpu().numpy(),
        lambda qi, i: np.sqrt(((db[i].astype(np.float64)
                                - qb[qi].astype(np.float64)) ** 2).sum()), K)
    lb = {name: m.launches for name, m in mods.items()}
    for name, count in lb.items():
        if count <= 0:
            fail(f"kernel {name} was not launched by phase 12 (b)")
    for key in [k for k in index._device_cache if k[3] is not None]:
        del index._device_cache[key]
    del dev4
    torch.cuda.empty_cache()
    cross = {}
    if meshc is not None:
        for m in mods.values():
            m.launches = 0
        t2 = time.perf_counter()
        devc = index.device_index(chunk=CHUNK, mesh=meshc)
        sync_mesh(torch, meshc)
        cross["placement_s"] = time.perf_counter() - t2
        if [t.device for t in devc.db] != list(meshc.devices):
            fail("the cross-card mesh did not place a shard on each entry")
        cross["seconds"], gotc = run_paths(meshc, str(list(meshc.devices)))
        same(gotc["degraded exact ED"], got4["degraded exact ED"],
             "degraded exact ED across the cards")
        cross["launches"] = {name: m.launches for name, m in mods.items()}
        for name, count in cross["launches"].items():
            if count <= 0:
                fail(f"kernel {name} was not launched across the cards")
        for key in [k for k in index._device_cache if k[3] is not None]:
            del index._device_cache[key]
        del devc
        for dv in meshc.distinct:
            with torch.cuda.device(dv):
                torch.cuda.empty_cache()
        cross_txt = (f"on {[str(x) for x in meshc.devices]}: every path "
                     f"bitwise the [cuda:0] x 4 answer (degraded coverage "
                     f"and answers included), placement "
                     f"{cross['placement_s']:.3f} s, seconds "
                     f"{cross['seconds']}, launches {cross['launches']}")
    else:
        cross_txt = "across cards: not run (1 card)"
    out.update(mesh1_exact_s=t_m1, mesh4_s=times, launches_search=lb,
               coverage=cov, degraded_tied=tied, cross_device=cross)
    print(f"  (b) search_distributed on [cuda:0]: batch 0 of exact ED "
          f"bitwise phase 5's ({t_m1:.3f} s with its layout); on "
          f"[cuda:0] x 4, bitwise: exact ED and DTW (phases 5, 7), "
          f"extended ED nbr=4 with re-rank and approximate nbr=4 on the "
          f"placed DeviceIndex (phase 9); seconds {times}; shard 3 dead: "
          f"coverage {cov:.7f} = shard_coverage, answers equal the float64 "
          f"top-{K} over the live shards' rows (tied {tied}); launches "
          f"{lb}; {cross_txt} [{smi}]")

    # -- (c) search_step over the whole collection ---------------------------
    x = dev.db[0][:N]
    lo, hi = dev.leaf_lo_g, dev.leaf_hi_g
    for m in mods.values():
        m.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pos, dd, lbs = dist.search_step(q32, x, lo, hi, K)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    lc = {name: m.launches for name, m in mods.items()}
    if lc["pairwise_l2"] != 1 or lc["lb_paa_interval"] != 1:
        fail(f"search_step launches {lc}, not one pairwise_l2 and one "
             f"lb_paa_interval")
    ids = dev.ids[0][pos].cpu().numpy().astype(np.int64)
    dd, lbs = dd.cpu().numpy(), lbs.cpu().numpy()
    ok, gap = ties_only(np, ids, dd, *exact_ed[0][:2])
    if not ok:
        fail(f"search_step's answer is not phase 5's up to ties at rtol "
             f"1e-5 (max rel gap in d {gap:.3e})")
    swapped = step_against_exact(np, db, qb, ids, dd, *exact_ed[0][:2])
    if not (np.sqrt(lbs) <= dd[:, 0]).all():
        fail("search_step's sqrt(lbs) exceeds a nearest distance")
    Q = q32.shape[0]
    err = 0.0
    d2 = ops.pairwise_l2(q32, x)
    for s0 in (0, N // 2, N - 4096):
        xs = x[s0:s0 + 4096]
        want = ref.pairwise_l2_ref(q32, xs)
        scale = (q32 * q32).sum(1)[:, None] + (xs * xs).sum(1)[None, :]
        part = d2[:, s0:s0 + 4096]
        if not bool(((part - want).abs() <= 1e-5 * scale).all()):
            fail(f"pairwise_l2 at [{Q},{N},{n}] disagrees with its twin at "
                 f"columns {s0}..")
        if not torch.equal(part, ops.pairwise_l2(q32, xs)):
            fail(f"pairwise_l2 at [{Q},{N},{n}] is not bitwise a call over "
                 f"columns {s0}.. alone")
        err = max(err, float((part - want).abs().max()))
    del d2
    ms, host = time_ms(torch, ops.pairwise_l2, [(q32, x)] * 5, warmup=1)
    plain, _ = time_ms(torch, ref.pairwise_l2_ref, [(q32, x)] * 3, warmup=1)
    lib, _ = time_ms(torch, lambda q, y: torch.cdist(q, y).square(),
                     [(q32, x)] * 3, warmup=1)
    b_ms, b_by = bound(4 * (Q * n + N * n + Q * N),
                       2 * Q * N * n + 2 * (Q + N) * n + 4 * Q * N)
    torch.cuda.empty_cache()
    out.update(search_step_s=step_s, search_step_launches=lc,
               search_step_gap=gap, search_step_swapped=swapped,
               pairwise_l2_ms=ms, pairwise_l2_bound_ms=b_ms,
               pairwise_l2_plain_ms=plain, pairwise_l2_library_ms=lib)
    print(f"  (c) search_step at [{Q},{N},{n}]: {step_s:.3f} s (one "
          f"pairwise_l2, one lb_paa_interval: {lc}); the ids phase 5's "
          f"up to ties and the distances within rtol 1e-5 of phase 5's "
          f"(max rel gap in d {gap:.3e}, {swapped} ids swapped); every d² "
          f"within 1e-5·(|q|² + |x|²) of its float64 value; sqrt(lbs) <= "
          f"d[:, 0]; pairwise_l2 at that shape: "
          f"within 1e-5 of its twin on three column slices (max |err| "
          f"{err:.3e}) and bitwise a call over each slice; kernel "
          f"{ms:.5f} ms (host {host:.4f} ms a call), twin {plain:.5f} ms, "
          f"torch.cdist(q, x).square() {lib:.5f} ms, bound {b_ms:.6f} ms "
          f"({b_by}), {100 * b_ms / ms:.1f}% of the bound [{smi}]")
    new_rows = {"pairwise_l2": [dict(
        shape=[Q, N, n], path="search_step (12 c)", launches=1, ms=ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        max_abs_err=err)]}
    return out, new_rows


def baselines_phase(torch, np, sd, ops, ref, mods, baselines, DumpyIndex,
                    params, db, batches, floor, smi) -> tuple[dict, list]:
    """Phase 12 (d): Dumpy, iSAX2+ and TARDIS over the first 250 000 series,
    each through the same device paths: its host build, structure, set-up,
    exact ED batch 0 against a float64 brute force over those series, and
    recall@10 of extended search at nbr 1, 4, 16 against it, with
    ``lb_paa_interval`` timed at its leaf and routing edge tables.  Every
    check fails the run on a miss; returns ``(summary, kernel rows)``."""
    isax2plus, tardis = baselines
    n_cut = min(BASELINE_ROWS, db.shape[0])
    sub = db[:n_cut]
    if n_cut < db.shape[0]:
        print(f"  REDUCED: the first {n_cut} of {db.shape[0]} series (the "
              f"iSAX2+ host build grows faster than linearly)")
    qb = batches[0]
    q32 = torch.from_numpy(qb).cuda()
    paa, _ = ops.sax_encode(q32, params.sax.w, params.sax.b)
    w, n = params.sax.w, sub.shape[1]
    builders = (("dumpy", lambda: DumpyIndex.build(sub, params)),
                ("isax2plus", lambda: isax2plus.build_isax2plus(sub, params)),
                ("tardis", lambda: tardis.build_tardis(sub, params)))
    summary, kernel_rows, gt = {}, [], None
    for name, build in builders:
        t1 = time.perf_counter()
        idx = build()
        build_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        dev_s = idx.device_index(chunk=CHUNK, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t1
        if gt is None:
            bd, bi = brute_force(torch, dev_s, q32, K)
            gt = (bd.cpu().numpy(), bi.cpu().numpy())
        sd.exact_search_device_batch(idx, qb, K, dev=dev_s)      # warm-up
        for m in mods.values():
            m.launches = 0
        t1 = time.perf_counter()
        ids, d, vis = sd.exact_search_device_batch(idx, qb, K, dev=dev_s)
        exact_s = time.perf_counter() - t1
        la = {k: m.launches for k, m in mods.items()}
        for k in ("sax_encode", "lb_paa_interval", "pairwise_l2"):
            if la[k] <= 0:
                fail(f"kernel {k} was not launched on {name}'s exact batch")
        tied = check_exact(
            np, ids, d, gt[0], gt[1],
            lambda qi, i: np.sqrt(((sub[i].astype(np.float64)
                                    - qb[qi].astype(np.float64)) ** 2
                                   ).sum()), K)
        truth = [set(r.tolist()) for r in ids]
        ext = {}
        for nbr in NBRS:
            for m in mods.values():
                m.launches = 0
            t1 = time.perf_counter()
            with recorded_calls(ops, keep=8) as rec:
                e_ids = sd.extended_search_device_batch(idx, qb, K, nbr=nbr,
                                                        dev=dev_s)[0]
            ext_s = time.perf_counter() - t1
            recall = float(np.mean([len(g & set(r[r >= 0].tolist())) / K
                                    for g, r in zip(truth, e_ids)]))
            ext[nbr] = dict(recall=recall, s=ext_s, launches={
                k: m.launches for k, m in mods.items()})
        # the last batch's lb_paa_interval launches, table by table
        per_table = {
            label: sum(a[2] is lo for a, _ in rec.calls["lb_paa_interval"])
            for label, lo in (("leaf table", dev_s.leaf_lo_g),
                              ("routing edges", dev_s.rt_lo))}
        if sum(per_table.values()) != ext[NBRS[-1]]["launches"][
                "lb_paa_interval"]:
            fail(f"{name}: lb_paa_interval launches at nbr {NBRS[-1]} "
                 f"{ext[NBRS[-1]]['launches']['lb_paa_interval']} are not "
                 f"those on its two tables {per_table}")
        recalls = [ext[nbr]["recall"] for nbr in NBRS]
        if recalls != sorted(recalls):
            fail(f"{name}: recall is not monotone in nbr: {recalls}")
        tables = {}
        for label, lo, hi in (("leaf table", dev_s.leaf_lo_g,
                               dev_s.leaf_hi_g),
                              ("routing edges", dev_s.rt_lo, dev_s.rt_hi)):
            a = (paa, paa, lo, hi, n)
            lbpaa_bitwise(torch, ops, ref, a, f"{name} {label}")
            ms, host = time_ms(torch, ops.lb_paa_interval, [a] * 20)
            plain, _ = time_ms(torch, ref.lb_paa_interval_ref, [a] * 20)
            Q, L = paa.shape[0], lo.shape[0]
            b_ms, b_by = bound(4 * (2 * Q * w + 2 * L * w + Q * L),
                               7 * Q * L * w + Q * L)
            tables[label] = dict(shape=[Q, L, w], ms=ms, plain_ms=plain,
                                 bound_ms=b_ms, bound_by=b_by,
                                 launches=per_table[label])
            kernel_rows.append(dict(
                shape=[Q, L, w], path=f"{name} {label} (12 d)",
                launches=per_table[label],
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None))
            print(f"    {name} lb_paa_interval {label} [{Q},{L},{w}]: "
                  f"bitwise equal to the in-order sum; kernel {ms:.5f} ms "
                  f"(host {host:.4f} ms a call; launch floor {floor:.5f} "
                  f"ms), twin {plain:.5f} ms, bound {b_ms:.6f} ms ({b_by})"
                  f" [{smi}]")
        st = idx.stats
        summary[name] = dict(
            build_s=build_s, leaves=idx.flat.n_leaves, height=st.height,
            fill_factor=st.fill_factor, routing_edges=int(dev_s.rt_lo.shape[0]),
            lmax=dev_s.lmax, setup_s=setup_s, exact_s=exact_s,
            exact_launches=la, exact_tied=tied,
            spans_visited=float(vis.mean()), extended=ext,
            lb_paa_interval=tables)
        print(f"  (d) {name}: host build {build_s:.3f} s; {idx.flat.n_leaves}"
              f" leaves, height {st.height}, fill factor "
              f"{st.fill_factor:.7f}, {dev_s.rt_lo.shape[0]} routing edges, "
              f"lmax {dev_s.lmax}; DeviceIndex {setup_s:.3f} s; exact ED "
              f"batch 0 {exact_s:.3f} s, equal to the float64 brute force "
              f"over the {n_cut} series (tied {tied}), mean spans visited "
              f"{float(vis.mean()):.2f}, launches {la}; extended recall@{K}"
              f" at nbr {NBRS}: {recalls} (seconds "
              f"{[round(ext[x]['s'], 4) for x in NBRS]}) [{smi}]")
        del idx, dev_s
        torch.cuda.empty_cache()
    return summary, kernel_rows


def census_kernels(mods, calls: dict) -> None:
    """Fail unless the census's kernel calls are the kernels' own launch
    counts (each wrapper counts where it launches): a call the census did
    not see, or one it saw that launched nothing."""
    launches = {name: m.launches for name, m in mods.items()}
    seen = {name: calls.get(name, 0) for name in mods}
    if seen != launches:
        fail(f"census kernel calls {seen} differ from the launches {launches}")


def analysis_phase(torch, np, sd, mods, index, dev, batches, dtw_batches,
                   results, dtw_results, paths_b0, smi) -> dict:
    """Phase 13: the analysis gates on the card, parts (a)–(d) (see the
    module docstring)."""
    from collections import Counter

    from repro_torch.analysis import (audit, contracts, lint, recompile,
                                      registry)
    out = {}
    # (a) the lint
    t1 = time.perf_counter()
    paths = lint.default_paths()
    findings = lint.lint_paths(paths)
    for f in findings:
        print(f"  {f}")
    if findings:
        fail(f"the lint found {len(findings)} finding(s)")
    out["lint_suppressions"] = lint.count_suppressions(paths)
    print(f"  (a) lint: 0 findings, {out['lint_suppressions']} suppressions "
          f"({time.perf_counter() - t1:.3f} s)")

    # (b) every registered entry on the card against the CPU golden
    t1 = time.perf_counter()
    state = registry.audit_state("cuda")
    for e in registry.entries():
        e.setup(state)()                # the first launches load modules
    torch.cuda.synchronize()
    for m in mods.values():
        m.launches = 0
    contracts_b, calls = {}, Counter()
    for e in registry.entries():
        c = contracts.run_entry(e, "cuda", warm=False)[1].contract()
        contracts_b[e.name] = c
        calls.update(c["kernel_calls"]["histogram"])
        print(f"  (b) {e.name:26s} {audit.summary(c)}")
    census_kernels(mods, calls)
    for name in mods:
        if not calls[name]:
            fail(f"kernel {name} was not launched by phase 13 (b)")
    if audit.run_audit(device="cuda", results=contracts_b) != 0:
        fail("the audit on the card failed (see DRIFT / POLICY above)")
    out["audit"] = {n: {k: c[k] for k in ("kernel_calls", "host_syncs",
                                          "eager_launches", "peak_bytes")}
                    for n, c in contracts_b.items()}
    print(f"  (b) audit on the card: {len(contracts_b)} entries, kernel "
          f"calls {dict(calls)} ({time.perf_counter() - t1:.3f} s)")

    # (c) the steady-state sweep on the card
    t1 = time.perf_counter()
    rep = recompile.verify_sweep(device="cuda")
    out["sweep"] = {"combos": rep.combos, "builds": rep.builds,
                    "loads": rep.loads, "launch_syncs": rep.launch_syncs}
    print(f"  (c) sweep: {rep.combos} combinations twice, steady; "
          f"DeviceIndex builds {rep.builds}, library builds {rep.loads}, "
          f"syncs inside bucket launches {rep.launch_syncs} "
          f"({time.perf_counter() - t1:.3f} s)")

    # (d) one batch of each main-path entry at the collection's size
    t1 = time.perf_counter()
    builds = index._n_device_builds
    ks, nbrs, mets = serving_knobs(SERVE_MAX_BATCH, 0)
    qs64 = np.concatenate(batches)[:SERVE_MAX_BATCH]
    launch_censuses = []

    def bucket():
        orig = sd.bucket_search_launch

        def launch(*a, **kw):
            with contracts.Census("cuda") as c:
                res = orig(*a, **kw)
            launch_censuses.append(c)
            return res

        sd.bucket_search_launch = launch
        try:
            return sd.bucket_search_device_batch(
                index, qs64, ks, nbrs, mets, k_max=SERVE_K_MAX,
                nbr_max=SERVE_NBR_MAX, band=BAND, dev=dev)
        finally:
            sd.bucket_search_launch = orig

    runs = (
        ("exact ED", lambda: sd.exact_search_device_batch(
            index, batches[0], K, chunk=CHUNK, return_stats=True)),
        ("exact DTW cluster", lambda: sd.exact_search_device_batch(
            index, dtw_batches[0], K, chunk=CHUNK, metric="dtw", band=BAND,
            return_stats=True)),
        ("approximate nbr 4", lambda: sd.approximate_search_device_batch(
            index, batches[0], K, nbr=CENSUS_NBR, dev=dev)),
        ("extended ED nbr 4", lambda: sd.extended_search_device_batch(
            index, batches[0], K, nbr=CENSUS_NBR, chunk=CHUNK)),
        ("extended DTW nbr 4", lambda: sd.extended_search_device_batch(
            index, dtw_batches[0], K, nbr=CENSUS_NBR, chunk=CHUNK,
            metric="dtw", band=BAND)),
        ("bucket 64 mixed", bucket))
    phase9 = {"approximate nbr 4": ("ED", "approximate", CENSUS_NBR, None),
              "extended ED nbr 4": ("ED", "extended", CENSUS_NBR, True),
              "extended DTW nbr 4": ("DTW", "extended", CENSUS_NBR, True)}
    out["main_path"] = {}
    for label, fn in runs:
        for m in mods.values():
            m.launches = 0
        with contracts.Census("cuda") as c:
            res = fn()
        census_kernels(mods, c.kernel_calls)
        row = {"kernel_calls": dict(c.kernel_calls),
               "eager_launches": c.eager_launches,
               "aten_ops": sum(c.aten_ops.values()),
               "host_syncs": dict(c.host_syncs), "syncs": c.n_syncs,
               "peak_bytes": c.peak_bytes,
               "peak_over_resident": c.peak_bytes - c.base_bytes}
        out["main_path"][label] = row
        print(f"  (d) {label}: kernel calls {row['kernel_calls']}, eager "
              f"launches {row['eager_launches']} (aten ops "
              f"{row['aten_ops']}), host syncs {row['syncs']} "
              f"{row['host_syncs']}, peak {row['peak_bytes']} bytes "
              f"({row['peak_over_resident']} over the resident)")
        if "float64" in c.dtypes:
            fail(f"phase 13 (d) {label}: a float64 result on the device")
        if label == "exact ED":
            want = st_syncs = res[3]["host_syncs"]
            want += 1 + 3           # the query upload, three downloads
            if c.n_syncs != want:
                fail(f"exact ED census: {c.n_syncs} syncs, the search "
                     f"reports {st_syncs} (+ 1 upload, 3 downloads)")
            if not all(np.array_equal(a, b)
                       for a, b in zip(res[:3], results[0])):
                fail("exact ED under the census differs from phase 5")
            row["reported_host_syncs"] = st_syncs
        elif label == "exact DTW cluster":
            if not all(np.array_equal(a, b)
                       for a, b in zip(res[:3], dtw_results[0])):
                fail("exact DTW under the census differs from phase 7")
            row["reported_host_syncs"] = res[3]["host_syncs"]
        elif label in phase9:
            if not all(np.array_equal(a, b)
                       for a, b in zip(res, paths_b0[phase9[label]])):
                fail(f"{label} under the census differs from phase 9")
        elif label == "bucket 64 mixed":
            want = sd.bucket_search_device_batch(
                index, qs64, ks, nbrs, mets, k_max=SERVE_K_MAX,
                nbr_max=SERVE_NBR_MAX, band=BAND, dev=dev)
            if not all(np.array_equal(a, b) for a, b in zip(res, want)):
                fail("the bucket under the census differs from one without")
            (lc,) = launch_censuses
            row["launch_syncs"] = lc.n_syncs
            row["launch_eager_launches"] = lc.eager_launches
            if lc.n_syncs:
                fail(f"the 64-lane bucket launch synced: {lc.host_syncs}")
    if index._n_device_builds != builds:
        fail("phase 13 (d) built another DeviceIndex layout")
    print(f"  (d) {len(runs)} censused batches on the resident "
          f"DeviceIndex, no layout built ({time.perf_counter() - t1:.3f} s)"
          f"; card: {smi}")
    return out


def lm_batch(np, cfg, B: int, S: int, seed: int) -> dict:
    """A batch of numpy arrays as ``tests/test_models.py`` makes it."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int64)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def lm_run(torch, tfm, registry, model, batch: dict) -> dict:
    """One reduced model's train logits, loss, prefill of S-1 tokens and
    one decode step (of token S-1 into the prefill cache grown by a slot),
    as CPU tensors; then the gradients of the loss."""
    S = batch["tokens"].shape[1]
    with torch.no_grad():
        logits = tfm.forward_train(model, batch)
        loss = registry.loss_fn(model, batch)
        pre = dict(batch, tokens=batch["tokens"][:, :S - 1])
        last, caches = tfm.forward_prefill(model, pre)
        caches = tfm.grow_cache(caches, S - 1, S)
        dec, caches = tfm.forward_decode(
            model, caches, batch["tokens"][:, S - 1:], S - 1)
    model.zero_grad()
    registry.loss_fn(model, batch).backward()
    grads = [p.grad for p in model.parameters()]
    host = lambda t: t.detach().float().cpu()          # noqa: E731
    flat = {}

    def walk(tree, at):
        for k, v in (tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
            if isinstance(v, (dict, list)):
                walk(v, f"{at}/{k}")
            else:
                flat[f"{at}/{k}"] = host(v)
    walk(caches, "cache")
    return {"logits": host(logits), "loss": host(loss),
            "prefill_logits": host(last), "decode_logits": host(dec),
            **flat, "grad_finite": all(bool(torch.isfinite(g).all())
                                       for g in grads),
            "grad_abs_sum": float(sum(g.abs().sum() for g in grads))}


def lm_blocks(torch, tfm, cpu_model, card_model, batch: dict,
              device: str) -> float:
    """Each block of the card's model run alone on the inputs its CPU twin
    saw (prefill of S-1 tokens, then the decode step), against the CPU
    block's outputs: the largest max |d| over an output's magnitude."""
    def snap(t):   # a copy: the decode step updates attention caches in place
        if isinstance(t, torch.Tensor):
            return t.clone()
        if isinstance(t, (tuple, list)):
            return type(t)(snap(v) for v in t)
        if isinstance(t, dict):
            return {k: snap(v) for k, v in t.items()}
        return t

    seen = []
    hooks = [blk.register_forward_hook(
        lambda mod, args, out, name=name: seen.append(
            (name, snap(args), snap(out))))
        for name, blk in cpu_model.named_modules()
        if isinstance(blk, tuple(tfm.BLOCKS.values()))]
    S = batch["tokens"].shape[1]
    with torch.no_grad():
        _, caches = tfm.forward_prefill(
            cpu_model, dict(batch, tokens=batch["tokens"][:, :S - 1]))
        caches = tfm.grow_cache(caches, S - 1, S)
        tfm.forward_decode(cpu_model, caches, batch["tokens"][:, S - 1:],
                           S - 1)
    for h in hooks:
        h.remove()
    blocks = dict(card_model.named_modules())
    to = lambda t: (t.to(device) if isinstance(t, torch.Tensor) else   # noqa
                    {k: to(v) for k, v in t.items()} if isinstance(t, dict)
                    else t)
    # the card's block gets its own copy of the input cache, as it too
    # writes in place
    worst = 0.0
    for name, (x, ctx, cache), (y, st) in seen:
        with torch.no_grad():
            gy, gst = blocks[name](to(x), ctx, to(cache))
        for what, g, w in [("y", gy, y)] + [(k, gst[k], st[k]) for k in st]:
            rel = float((g.cpu() - w).abs().max()) / max(
                float(w.abs().max()), 1.0)
            worst = max(worst, rel)
            if rel > LM_BLOCK_TOL:
                fail(f"block {name} ({ctx.mode}) {what}: card vs CPU max |d|"
                     f" {rel:.3g} of its magnitude, beyond {LM_BLOCK_TOL}")
    return worst


def lm_reduced(torch, np, copy, reduced, tfm, registry, seed: int,
               device: str) -> dict:
    """Phase 14 (a): every architecture at ``reduced(...)`` on the card
    against the same parameters and batch on the CPU."""
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for float32 matmuls: the card's float32 checks "
             "need it off")
    out = {}
    for name in registry.ARCH_NAMES:
        # lint: allow-timing: each architecture's seconds end on host copies
        t1 = time.perf_counter()
        cfg = reduced(registry.get_config(name))
        cpu_model = tfm.init_params(cfg, torch.Generator().manual_seed(seed),
                                    "cpu")
        card_model = copy.deepcopy(cpu_model).to(device)
        nb = lm_batch(np, cfg, LM_B, LM_S, seed)
        batch = {k: torch.from_numpy(v) for k, v in nb.items()}
        want = lm_run(torch, tfm, registry, cpu_model, batch)
        got = lm_run(torch, tfm, registry, card_model,
                     {k: v.to(device) for k, v in batch.items()})
        blockwise = name in LM_BLOCKWISE
        tol = LM_TOL
        worst = 0.0
        for key, w in want.items():
            if not isinstance(w, torch.Tensor):
                continue
            g = got[key]
            if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                fail(f"{name} {key}: shape {tuple(g.shape)} vs "
                     f"{tuple(w.shape)} or not finite on the card")
            err = float((g - w).abs().max()) if g.numel() else 0.0
            worst = max(worst, err)
            if blockwise:
                scale = max(float(w.abs().max()) if w.numel() else 0.0, 1.0)
                if err > LM_WHOLE_TOL * scale:
                    fail(f"{name} {key}: card vs CPU max |d| {err:.3g}, "
                         f"beyond {LM_WHOLE_TOL} of its magnitude {scale:.3g}")
            elif not torch.allclose(g, w, atol=tol, rtol=tol):
                fail(f"{name} {key}: card vs CPU max |d| {err:.3g} beyond "
                     f"atol = rtol = {tol}")
        full, last, dec = (got["logits"], got["prefill_logits"],
                           got["decode_logits"])
        if not torch.allclose(last[:, 0], full[:, LM_S - 2], atol=2e-2,
                              rtol=2e-2):
            fail(f"{name}: prefill's last logits differ from forward_train "
                 f"beyond 2e-2 on the card")
        if not torch.allclose(dec[:, 0], full[:, LM_S - 1], atol=7e-2,
                              rtol=5e-2):
            fail(f"{name}: decode at S-1 differs from forward_train beyond "
                 f"7e-2 / 5e-2 on the card")
        if not got["grad_finite"] or not got["grad_abs_sum"] > 0:
            fail(f"{name}: gradients on the card not finite or all zero")
        block_rel = (lm_blocks(torch, tfm, cpu_model, card_model, batch,
                               device) if blockwise else None)
        out[name] = {"max_abs_err": worst,
                     "tol": f"{LM_WHOLE_TOL} of magnitude" if blockwise
                     else tol,
                     "block_max_rel": block_rel,
                     "loss": float(got["loss"]),
                     "s": time.perf_counter() - t1}
        held = (f"each array within {LM_WHOLE_TOL} of its magnitude; each "
                f"block alone within {LM_BLOCK_TOL}: worst {block_rel:.3g}"
                if blockwise else f"atol = rtol = {tol}")
        print(f"  (a) {name}: card vs CPU max |d| {worst:.3g} ({held}), "
              f"loss {float(got['loss']):.6f}, grads finite, "
              f"{out[name]['s']:.3f} s")
    return out


def olmo_bytes_flops(cfg, B: int, S: int, cache_len: int) -> tuple:
    """(prefill FLOPs, train FLOPs, decode-step bytes) of OLMo-1B: 2 per
    multiply-add of every weight product, causal attention (QK and PV over
    the S²/2 pairs), the head on the last position (prefill) or all of them
    (train); a decode step reads every weight but the embedding table once
    (float32) and ``cache_len`` positions of K and V (bfloat16)."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    layer = 4 * d * d + 3 * d * f
    attn = L * 2 * 2 * B * (S * S / 2) * d
    prefill = 2 * L * layer * B * S + attn + 2 * d * cfg.vocab * B
    train = 2 * (L * layer + d * cfg.vocab) * B * S + attn
    weights = (L * layer + d * cfg.vocab) * 4
    cache = L * 2 * B * cache_len * cfg.kv_dim * 2
    return prefill, train, weights + cache


def lm_olmo(torch, np, copy, dataclasses, tfm, registry, seed: int, smi,
            device: str, n_layers: int | None = None) -> dict:
    """Phase 14 (b): OLMo-1B at full width on the card (``n_layers`` cuts
    the depth for a rehearsal only)."""
    cfg = registry.get_config("olmo-1b")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    resident = None
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    B, S, T = OLMO_B, OLMO_S, OLMO_STEPS
    # lint: allow-timing: sync() is torch.cuda.synchronize on the card
    t1 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    model = tfm.init_params(cfg, gen, device)
    n_params = sum(p.numel() for p in model.parameters())
    sync()
    print(f"  (b) olmo-1b: {n_params} parameters ({n_params * 4 / 1e9:.3f} GB"
          f" float32) made on the card in {time.perf_counter() - t1:.3f} s")
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + T))
                              ).to(device)
    prompt = {"tokens": tokens[:, :S]}

    def timed(fn):
        # lint: allow-timing: sync() is torch.cuda.synchronize on the card
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t) * 1e3

    with torch.no_grad():
        timed(lambda: tfm.forward_prefill(model, prompt))     # warm-up
        (last, caches), prefill_ms = timed(
            lambda: tfm.forward_prefill(model, prompt))
        caches = tfm.grow_cache(caches, S, S + T)
        step_ms, dec = [], []
        for i in range(T):
            (lg, caches), ms = timed(lambda: tfm.forward_decode(
                model, caches, tokens[:, S + i:S + i + 1], S + i))
            step_ms.append(ms)
            dec.append(lg[:, 0].float())
        dec = torch.stack(dec, 1)                         # [B, T, V]
        timed(lambda: tfm.forward_train(model, prompt))       # warm-up
        _, train_ms = timed(lambda: registry.loss_fn(model, prompt))
        loss = float(registry.loss_fn(model, prompt))
        full = tfm.forward_train(model, {"tokens": tokens}).float()
        m32 = copy.copy(model)                 # the same parameters
        m32.cfg = dataclasses.replace(cfg, compute_dtype="float32")
        full32 = tfm.forward_train(m32, {"tokens": tokens}).float()
        small = {"tokens": tokens[:OLMO_F32_B, :OLMO_F32_S]}
        lo = tfm.forward_train(model, small).float()
        hi = tfm.forward_train(m32, small).float()
        profiles = {}
        if cuda:
            profiles["prefill"] = profile_lm(
                torch, f"prefill {B} x {S}",
                lambda: tfm.forward_prefill(model, prompt), 1)
            last_tok = tokens[:, S + T - 1:S + T]
            profiles["decode_step"] = profile_lm(
                torch, "a decode step (rewriting the last position)",
                lambda: tfm.forward_decode(model, caches, last_tok,
                                           S + T - 1), 4)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    for what, t in (("prefill logits", last), ("decode logits", dec),
                    ("train logits", full), ("float32 logits", full32)):
        if not bool(torch.isfinite(t.float()).all()):
            fail(f"olmo-1b: {what} not finite")
    if not np.isfinite(loss):
        fail(f"olmo-1b: loss {loss} not finite")
    pos = [round(j * (T - 1) / (OLMO_CHECKS - 1)) for j in range(OLMO_CHECKS)]
    d_dec = dec[:, pos]
    d_full = full[:, [S + j for j in pos]]
    d_f32 = full32[:, [S + j for j in pos]]
    rms = float(d_full.pow(2).mean().sqrt())
    rel = float((d_dec - d_full).abs().max()) / rms
    gap = float((d_full - d_f32).abs().max()) / rms
    agree = float((d_dec.argmax(-1) == d_full.argmax(-1)).float().mean())
    limit = max(2e-2, 2 * gap)
    if agree < 7 / 8:
        fail(f"olmo-1b: decode's argmax agrees with forward_train's at "
             f"{agree:.3f} of {B} x {OLMO_CHECKS} positions, below 7/8")
    if rel > limit:
        fail(f"olmo-1b: decode vs forward_train max |d| / RMS {rel:.4g} "
             f"beyond {limit:.4g} (2e-2, or twice bf16's own gap {gap:.4g})")
    f32_rel = float((lo - hi).abs().max() / hi.pow(2).mean().sqrt())
    f32_rms = float((lo - hi).pow(2).mean().sqrt() / hi.pow(2).mean().sqrt())
    f32_agree = float((lo.argmax(-1) == hi.argmax(-1)).float().mean())
    prefill_f, train_f, step_b = olmo_bytes_flops(cfg, B, S, S + T // 2)
    dec_ms = float(np.median(step_ms))
    out = {
        "card": smi, "params": n_params, "B": B, "S": S, "steps": T,
        "prefill_ms": prefill_ms,
        "prefill_tok_s": B * S / prefill_ms * 1e3,
        "prefill_bound_ms": prefill_f / BF16_OPS_PER_S * 1e3,
        "decode_step_ms_median": dec_ms,
        "decode_step_ms_mean": float(np.mean(step_ms)),
        "decode_tok_s": B * T / sum(step_ms) * 1e3,
        "decode_step_bound_ms": step_b / HBM_BYTES_PER_S * 1e3,
        "decode_tok_s_bound": B / (step_b / HBM_BYTES_PER_S),
        "train_loss_ms": train_ms,
        "train_bound_ms": train_f / BF16_OPS_PER_S * 1e3,
        "loss": loss, "max_memory_allocated": peak,
        "allocated_before": resident,
        "decode_vs_train_max_over_rms": rel,
        "bf16_vs_f32_gap_same_positions": gap,
        "decode_vs_train_argmax_agree": agree,
        "bf16_vs_f32_small_max_over_rms": f32_rel,
        "bf16_vs_f32_small_rms_rel": f32_rms,
        "bf16_vs_f32_small_argmax_agree": f32_agree,
        "profiles": profiles,
    }
    print(f"  (b) prefill {B} x {S}: {prefill_ms:.3f} ms, "
          f"{out['prefill_tok_s']:.1f} tokens/s (bound "
          f"{out['prefill_bound_ms']:.3f} ms: {prefill_f / 1e12:.2f} TFLOP at"
          f" the bf16 peak) [{smi}]")
    print(f"  (b) decode {T} steps x {B}: median {dec_ms:.3f} ms a step, "
          f"{out['decode_tok_s']:.1f} tokens/s (bound "
          f"{out['decode_step_bound_ms']:.3f} ms a step: {step_b / 1e9:.3f} "
          f"GB at {HBM_BYTES_PER_S / 1e12} TB/s, "
          f"{out['decode_tok_s_bound']:.1f} tokens/s) [{smi}]")
    print(f"  (b) forward_train + loss {B} x {S}: {train_ms:.3f} ms (bound "
          f"{out['train_bound_ms']:.3f} ms), loss {loss:.4f}; peak memory "
          f"{peak} B ({resident} B allocated before the phase) [{smi}]")
    print(f"  (b) decode vs forward_train at {OLMO_CHECKS} positions: max |d|"
          f" / RMS {rel:.4g} (limit {limit:.4g}; bf16 vs float32 there "
          f"{gap:.4g}), argmax agreement {agree:.3f}")
    print(f"  (b) bf16 vs float32 compute at {OLMO_F32_B} x {OLMO_F32_S}: "
          f"max |d| / RMS {f32_rel:.4g}, RMS(d) / RMS {f32_rms:.4g}, argmax "
          f"agreement {f32_agree:.4f}")
    del model, m32, caches
    if cuda:
        torch.cuda.empty_cache()
    return out


def profile_lm(torch, label: str, fn, n: int, part: str = "b") -> dict:
    """``n`` calls of ``fn`` under ``torch.profiler``: the device's busy
    share of their wall time (a lower bound: the profiler lengthens the
    wall), device ms and kernel launches a call, the port's kernels' device
    ms a call by name, and the kernels taking most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    launches = sum(e.count for e in dev) / n
    top = sorted(dev, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    kernels = {name: sum(e.self_device_time_total for e in dev
                         if f"{name}_" in e.key and "_kernel" in e.key)
               / 1e3 / n for name in KERNELS}
    kernels = {k: v for k, v in kernels.items() if v}
    print(f"  ({part}) profile of {label}: wall {wall / n * 1e3:.3f} ms a "
          f"call, device busy {100 * busy / wall:.1f}% (not measured if 0), "
          f"{busy * 1e3 / n:.3f} device ms and {launches:.0f} device ops a "
          f"call; the port's kernels {kernels} ms a call")
    for e in top:
        print(f"      {e.key[:70]:70s} {e.count / n:6.1f} a call, "
              f"{e.self_device_time_total / 1e3 / n:9.3f} ms")
    return {"wall_ms": wall / n * 1e3, "busy_share": busy / wall,
            "device_ms": busy * 1e3 / n, "device_ops": launches,
            "kernels": kernels,
            "top": [[e.key[:70], e.self_device_time_total / 1e3 / n]
                    for e in top]}


def lm_phase(torch, np, seed: int, smi, device: str = "cuda") -> dict:
    import copy
    import dataclasses
    from repro_torch.configs.base import reduced
    from repro_torch.models import registry, transformer as tfm
    return {"reduced": lm_reduced(torch, np, copy, reduced, tfm, registry,
                                  seed, device),
            "olmo_1b": lm_olmo(torch, np, copy, dataclasses, tfm, registry,
                               seed, smi, device)}


def lm_serve_small(torch, np, copy, serve, tfm, sd, head_cls, preset_config,
                   smi, device: str) -> dict:
    """Phase 15 (a): ``serve.generate`` on the smoke preset (float32, TF32
    off) with the same seed-0 parameters on the CPU and the card: plain
    tokens equal; with the head, ``step_batch_via == step_batch`` at each
    card step and tokens equal to the CPU's, unless the first differing
    step's candidate sets differ only by ties at rtol 1e-5 (then compared
    up to that step)."""
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for float32 matmuls: phase 15 (a) needs it off")
    cfg = preset_config("olmo-1b", "smoke")
    cpu_model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    models = {"cpu": cpu_model, "card": copy.deepcopy(cpu_model).to(device)}
    prompt = np.random.default_rng(0).integers(0, cfg.vocab,
                                               (SERVE_B, SERVE_P))
    plain = {d: serve.generate(cfg, m, prompt, SERVE_T)
             for d, m in models.items()}
    if not np.array_equal(plain["card"], plain["cpu"]):
        fail(f"plain decode: the card's tokens differ from the CPU's in "
             f"{int((plain['card'] != plain['cpu']).sum())} places")
    lm_head = cpu_model.lm_head.detach().numpy()
    heads, seen, toks = {}, {}, {}
    for d, m in models.items():
        head = heads[d] = head_cls(lm_head, device=m.embed.device,
                                   **SERVE_HEAD)
        seen[d] = []
        via = head.step_batch_via

        def record(fe, H, via=via, log=seen[d], **kw):
            out = via(fe, H, **kw)
            log.append((H.copy(), out))
            return out
        head.step_batch_via = record
        with head.make_frontend(max_batch=max(SERVE_B, 4),
                                max_wait=SERVE_MAX_WAIT) as fe:
            toks[d] = serve.generate(cfg, m, prompt, SERVE_T,
                                     knn_head=head, frontend=fe)
    card = heads["card"]
    for i, (H, t) in enumerate(seen["card"]):
        if not np.array_equal(card.step_batch(H, track_exact=False), t):
            fail(f"head decode step {i}: step_batch_via differs from "
                 f"step_batch on the card")
    same = toks["card"] == toks["cpu"]
    upto = SERVE_T
    if not same.all():
        upto = int(np.nonzero(~same.all(axis=0))[0][0])
        if upto == 0:
            fail("the head path's first token (the prefill's) differs")
        H = {d: seen[d][upto - 1][0] for d in heads}
        ans = {d: sd.extended_search_device_batch(
            heads[d].index, heads[d]._encode_queries(H[d]), heads[d].r,
            nbr=heads[d].nbr, rerank=False, dev=heads[d].device_index,
            metric=heads[d].metric)[:2] for d in heads}
        ok, gap = ties_only(np, *ans["card"], *ans["cpu"])
        rows = np.nonzero(~same[:, upto])[0]
        lg = [(H["cpu"][r] @ lm_head[:, toks[d][r, upto]]) for r in rows
              for d in heads]
        tie = np.allclose(lg[0::2], lg[1::2], rtol=1e-5, atol=0)
        if not (ok and tie):
            fail(f"head decode: the card's tokens differ from the CPU's at "
                 f"step {upto} beyond ties at rtol 1e-5 (candidates "
                 f"{'tied' if ok else 'differ'}, max rel {gap:.3e})")
        print(f"  (a) a tie at step {upto}, rows {rows.tolist()}: tokens "
              f"{toks['card'][rows, upto].tolist()} (card) and "
              f"{toks['cpu'][rows, upto].tolist()} (CPU), logits {lg}; "
              f"compared up to it")
    print(f"  (a) smoke preset, B {SERVE_B}, prompt {SERVE_P}, {SERVE_T} "
          f"tokens: plain tokens on the card equal the CPU's; with the head "
          f"step_batch_via == step_batch at all {len(seen['card'])} card "
          f"steps and the tokens equal the CPU's over {upto} of {SERVE_T} "
          f"positions [{smi}]")
    return {"plain_equal": True, "head_equal_upto": upto,
            "head_steps_checked": len(seen["card"])}


def lm_serve_full(torch, np, serve, tfm, head_cls, preset_config, mods, smi,
                  device: str) -> dict:
    """Phase 15 (b): OLMo-1B at full width through ``serve.generate`` with
    ``main``'s defaults, without and then with the head: prefill seconds,
    decode tokens/s and ms a step beside the step's bound, the head's build
    seconds, kernel launches a step (the wrappers' counts, as phase 13's
    census checks them) and device ms a step (profiled), its stats."""
    cfg = preset_config("olmo-1b", "full")
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.empty_cache()
    model = tfm.init_params(cfg, torch.Generator(device).manual_seed(0),
                            device)
    n_params = sum(p.numel() for p in model.parameters())
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_B, SERVE_P)).astype(np.int32)
    finite = [torch.ones((), dtype=torch.bool, device=device)]
    plain_prefill, plain_decode = tfm.forward_prefill, tfm.forward_decode

    def check(fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            finite[0] &= torch.isfinite(out[0]).all()
            return out
        return run

    _, _, bytes_step = olmo_bytes_flops(cfg, SERVE_B, SERVE_P,
                                        SERVE_P + SERVE_T // 2)
    bound_ms = bytes_step / HBM_BYTES_PER_S * 1e3
    out = {"params": n_params, "step_bound_ms": bound_ms,
           "step_bytes": bytes_step, "card": smi}
    t_build = head = fe = None
    for label in ("plain", "head"):
        if label == "head":
            # lint: allow-timing: sync() is torch.cuda.synchronize on the card
            t1 = time.perf_counter()
            head = head_cls(model.lm_head.detach().float().cpu().numpy(),
                            device=device, **SERVE_HEAD)
            sync()
            t_build = time.perf_counter() - t1
            fe = head.make_frontend(max_batch=max(SERVE_B, 4),
                                    max_wait=SERVE_MAX_WAIT)
        kw = dict(knn_head=head, frontend=fe)
        tfm.forward_prefill = check(plain_prefill)    # warm-up, every logit
        tfm.forward_decode = check(plain_decode)      # checked finite
        seen = []
        if head is not None:
            via = head.step_batch_via
            head.step_batch_via = lambda f, H, **k: (seen.append(H.copy()),
                                                     via(f, H, **k))[1]
        try:
            serve.generate(cfg, model, prompt, SERVE_T, **kw)
        finally:
            tfm.forward_prefill, tfm.forward_decode = plain_prefill, plain_decode
            if head is not None:
                head.step_batch_via = via
        if not bool(finite[0]):
            fail(f"olmo-1b serving ({label}): a logit not finite")
        for m in mods.values():
            m.launches = 0
        tm = {}
        serve.generate(cfg, model, prompt, SERVE_T, timings=tm, **kw)
        launches = {name: m.launches for name, m in mods.items()}
        steps = SERVE_T - 1
        step_ms = float(np.median(tm["step_s"])) * 1e3
        row = {"prefill_s": tm["prefill_s"], "decode_s": tm["decode_s"],
               "tok_s": SERVE_B * steps / tm["decode_s"],
               "step_ms_median": step_ms,
               "launches": launches,
               "launches_per_step": {k: v / steps
                                     for k, v in launches.items()}}
        print(f"  (b) olmo-1b {label}: prefill {SERVE_P} x {SERVE_B} "
              f"{tm['prefill_s']:.4f} s; decode {steps} steps "
              f"{row['tok_s']:.2f} tokens/s, median {step_ms:.3f} ms a step "
              f"(bound {bound_ms:.3f} ms: {bytes_step / 1e9:.3f} GB at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s); kernel launches {launches} "
              f"[{smi}]")
        if label == "head":
            for name in ("sax_encode", "lb_paa_interval"):
                if cuda and launches[name] <= 0:
                    fail(f"kernel {name} was not launched on the LM serving "
                         f"path with the head")
            prof = (profile_lm(
                torch, "the head alone, one decode step's hidden rows",
                lambda: head.step_batch_via(fe, seen[len(seen) // 2]),
                4, part="b") if cuda else {"device_ms": 0.0, "kernels": {}})
            s = head.stats
            fe.close()
            row.update(build_s=t_build, profile=prof,
                       exact_in_topr=s.exact_in_topr / s.tokens,
                       agree_argmax=s.agree_argmax / s.tokens,
                       frontend=fe.stats.snapshot())
            print(f"  (b) head over lm_head [{cfg.d_model}, {cfg.vocab}] "
                  f"({SERVE_HEAD}): build and upload {t_build:.3f} s; "
                  f"{sum(row['launches_per_step'].values()):.2f} kernel "
                  f"launches a step; device {prof['device_ms']:.3f} ms a "
                  f"step, of which kernels {prof['kernels']} ms [{smi}]")
            print(f"  (b) knn-softmax stats: recall@R="
                  f"{row['exact_in_topr']:.4f} argmax-agree="
                  f"{row['agree_argmax']:.4f} over {s.tokens} tokens")
            print(f"  (b) frontend stats: {row['frontend']}")
        out[label] = row
    del model, head
    if cuda:
        torch.cuda.empty_cache()
    return out


def train_flops(cfg, B: int, S: int) -> float:
    """A train step's model FLOPs: three times the forward's weight
    products (2 a multiply-add, the head over every position) and causal
    attention (QK and PV over S²/2 pairs), as ``olmo_bytes_flops``."""
    _, fwd, _ = olmo_bytes_flops(cfg, B, S, S)
    return 3 * fwd


def lm_train_100m(torch, np, shutil, tfm, preset_config, pipeline, opt,
                  ckpt_mod, trainer, make_train_step, param_tree, smi,
                  device: str) -> dict:
    """Phase 15 (c): the ``100m`` preset of the olmo-1b family (float32,
    TF32 off) trained as ``launch.train.main`` trains it, 20 steps of
    8 x 512 with checkpoints every 10 under ``build/``, under
    ``torch.use_deterministic_algorithms(True)``; a profile of one step;
    a checkpoint's save and restore; then the resume: 10 steps, a blocking
    checkpoint, a new ``Trainer`` resuming to 20, against the 20-step run
    (bitwise; within atol 1e-5, with default algorithms, if an op refuses
    determinism, which is printed)."""
    from repro_torch.models.common import leaves
    cfg = preset_config("olmo-1b", "100m")
    ocfg = opt.AdamWConfig(lr=3e-4, total_steps=TRAIN_STEPS,
                           warmup_steps=max(TRAIN_STEPS // 20, 5),
                           moment_dtype=cfg.moment_dtype)
    pipe = pipeline.TokenPipeline(pipeline.TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B))
    root = ROOT / "build" / "phase15"
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def run(total, sub, every, blocking=False):
        model = tfm.init_params(cfg, torch.Generator(device).manual_seed(0),
                                device)
        t = trainer.Trainer(trainer.TrainerConfig(
            total_steps=total, ckpt_every=every, ckpt_dir=str(root / sub),
            async_ckpt=not blocking), make_train_step(cfg, ocfg),
            pipe.batch_at)
        return t.run(model, opt.init(param_tree(model), ocfg))

    def runs():
        """The timed 40-step run and the resumed one; the peak memory of
        the first over what was allocated before it."""
        shutil.rmtree(root, ignore_errors=True)
        peak = None
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            peak = -torch.cuda.memory_allocated()
        full = run(TRAIN_STEPS, "t", TRAIN_CKPT)
        if cuda:
            peak += torch.cuda.max_memory_allocated()
        run(TRAIN_CKPT, "r", TRAIN_CKPT, blocking=True)
        res = run(TRAIN_STEPS, "r", 10 * TRAIN_STEPS)
        if res[2].resumed_from != TRAIN_CKPT:
            fail(f"100m resume: resumed from {res[2].resumed_from}")
        return full, res, peak

    refused = None
    torch.use_deterministic_algorithms(True)
    try:
        try:
            full, res, peak = runs()
        except RuntimeError as e:
            if "deterministic" not in str(e):
                raise
            refused = str(e).splitlines()[0]
            print(f"  (c) an op refuses determinism: {refused}")
    finally:
        torch.use_deterministic_algorithms(False)
    if refused is not None:
        full, res, peak = runs()
    model, state, rep = full
    n_params = sum(p.numel() for p in model.parameters())
    if rep.steps_run != TRAIN_STEPS or len(rep.losses) != TRAIN_STEPS:
        fail(f"100m: {rep.steps_run} steps, {len(rep.losses)} finite losses")
    first, last = np.mean(rep.losses[:4]), np.mean(rep.losses[-4:])
    if not last < first - 0.05:
        fail(f"100m: the loss did not fall: first 4 {first:.4f}, last 4 "
             f"{last:.4f}")
    step_s = float(np.median(rep.step_times[1:]))
    flops = train_flops(cfg, TRAIN_B, TRAIN_S)
    bound_ms = flops / F32_OPS_PER_S * 1e3
    out = {"params": n_params, "step_ms_median": step_s * 1e3,
           "steps_per_s": 1 / step_s, "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
           "step_bound_ms": bound_ms, "flops": flops, "peak_bytes": peak,
           "loss_first4": first, "loss_last4": last,
           "deterministic": refused is None,
           "losses": rep.losses,
           "stragglers": len(rep.straggler_events),
           "checkpoints": sorted(p.name for p in (root / "t").iterdir())}
    print(f"  (c) 100m ({n_params} parameters, float32), {TRAIN_STEPS} steps "
          f"of {TRAIN_B} x {TRAIN_S} ({'deterministic' if refused is None else 'default'}"
          f" algorithms): median {step_s * 1e3:.3f} ms a step, "
          f"{out['steps_per_s']:.3f} steps/s, {out['tokens_per_s']:.1f} "
          f"tokens/s (bound {bound_ms:.3f} ms: {flops / 1e12:.3f} TFLOP at "
          f"the float32 {F32_OPS_PER_S / 1e12:.0f} TFLOP/s); loss {first:.4f}"
          f" -> {last:.4f} (first and last 4); peak {peak} B over what was "
          f"allocated before; checkpoints "
          f"{out['checkpoints']} [{smi}]")
    worst = max(float((a.detach().float() - b.detach().float()).abs().max())
                for a, b in zip(leaves([param_tree(model), state]),
                                leaves([param_tree(res[0]), res[1]])))
    if refused is None and worst != 0.0:
        fail(f"100m resume: parameters and state differ from the "
             f"uninterrupted run's by {worst:.3g} under deterministic "
             f"algorithms")
    if refused is not None and worst > 1e-5:
        fail(f"100m resume: {worst:.3g} from the uninterrupted run, beyond "
             f"atol 1e-5")
    out.update(resume_max_abs=worst, resume_refused_op=refused)
    print(f"  (c) resume: {TRAIN_CKPT} steps, a blocking checkpoint, a new "
          f"Trainer to {TRAIN_STEPS}: parameters and AdamW state "
          f"{'bitwise' if worst == 0 else f'within {worst:.3g} of'} the "
          f"uninterrupted run's")
    del res

    tree = (param_tree(model), state)
    mgr = ckpt_mod.CheckpointManager(str(root / "io"))
    # lint: allow-timing: the save copies every leaf to the host, and
    # sync() is torch.cuda.synchronize on the card
    t1 = time.perf_counter()
    mgr.save(TRAIN_STEPS, tree, blocking=True)
    out["save_s"] = time.perf_counter() - t1
    out["ckpt_bytes"] = store_bytes(root / "io")
    t1 = time.perf_counter()
    back, _ = mgr.restore(TRAIN_STEPS, tree)
    sync()
    out["restore_s"] = time.perf_counter() - t1
    if not all(torch.equal(a, b) for a, b in zip(leaves(list(tree)),
                                                  leaves(list(back)))):
        fail("100m: a restored checkpoint differs from what was saved")
    print(f"  (c) checkpoint of step {TRAIN_STEPS}: {out['ckpt_bytes']} B, "
          f"blocking save {out['save_s']:.3f} s, restore to the card "
          f"{out['restore_s']:.3f} s, bitwise")
    del tree, back
    if cuda:
        step = make_train_step(cfg, ocfg)
        out["profile"] = profile_lm(
            torch, f"a 100m train step {TRAIN_B} x {TRAIN_S}",
            lambda: step(model, state, pipe.batch_at(TRAIN_STEPS)), 1,
            part="c")
    shutil.rmtree(root, ignore_errors=True)
    return out


def lm_train_full(torch, np, tfm, preset_config, pipeline, opt,
                  make_train_step, param_tree, smi, device: str) -> dict:
    """Phase 15 (d): OLMo-1B at full width (``remat="full"``, float32
    parameters, bf16 compute), train steps of 4 x 2048: ms a step beside
    its bound, peak memory beside the parameters, gradients and two moments
    alone, loss and grad norm finite, a profile of one step."""
    cfg = preset_config("olmo-1b", "full")
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    base = peak = None
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    model = tfm.init_params(cfg, torch.Generator(device).manual_seed(0),
                            device)
    n_params = sum(p.numel() for p in model.parameters())
    ocfg = opt.AdamWConfig(total_steps=100, warmup_steps=5,
                           moment_dtype=cfg.moment_dtype)
    state = opt.init(param_tree(model), ocfg)
    pipe = pipeline.TokenPipeline(pipeline.TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=FULL_S, global_batch=FULL_B))
    step = make_train_step(cfg, ocfg)
    ms, losses, norms = [], [], []
    for i in range(FULL_STEPS):
        batch = pipe.batch_at(i)
        # lint: allow-timing: sync() is torch.cuda.synchronize on the card
        sync()
        t1 = time.perf_counter()
        model, state, m = step(model, state, batch)
        sync()
        ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    if cuda:
        peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        fail(f"olmo-1b train step: loss {losses} or grad norm {norms} not "
             f"finite")
    flops = train_flops(cfg, FULL_B, FULL_S)
    attn = 3 * 2 * cfg.n_layers * FULL_B * FULL_S ** 2 * cfg.d_model
    floor_bytes = 4 * n_params * 4
    out = {"params": n_params, "step_ms": ms, "step_bound_ms":
           flops / BF16_OPS_PER_S * 1e3, "flops": flops,
           "attention_flops": attn, "peak_bytes": peak,
           "allocated_before": base, "state_floor_bytes": floor_bytes,
           "losses": losses, "grad_norms": norms}
    print(f"  (d) olmo-1b full width ({n_params} parameters), train steps of "
          f"{FULL_B} x {FULL_S}: {[round(x, 3) for x in ms]} ms (bound "
          f"{out['step_bound_ms']:.3f} ms: {flops / 1e12:.2f} TFLOP, "
          f"{attn / flops:.3f} of it attention, at the bf16 "
          f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s); loss {losses}, grad norm "
          f"{norms}; peak {peak} B (parameters, gradients and two moments "
          f"alone {floor_bytes} B; {base} B allocated before) [{smi}]")
    if cuda:
        out["profile"] = profile_lm(
            torch, f"a train step {FULL_B} x {FULL_S}",
            lambda: step(model, state, pipe.batch_at(FULL_STEPS)), 1,
            part="d")
    del model, state
    if cuda:
        torch.cuda.empty_cache()
    return out


def lm_entry_phase(torch, np, mods, smi, device: str = "cuda",
                   parts: str = "abcd") -> dict:
    """Phase 15: the LM entry points (``repro_torch.launch``,
    ``repro_torch.train``), parts (a)–(d) (those in ``parts``), each
    printed with its seconds."""
    import copy
    import shutil
    from repro_torch.core import search_device
    from repro_torch.data import tokens as pipeline
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.launch.train import preset_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.weights import param_tree
    from repro_torch.serving.knn_softmax import KnnSoftmaxHead
    from repro_torch.train import checkpoint, optimizer, trainer
    from repro_torch.train.train_step import make_train_step
    if device == "cuda":
        # lint: allow-timing: the build is host work (nvcc)
        t1 = time.perf_counter()
        _build.lib()             # built in phase 2, or here with --lm-only
        print(f"  kernel library ready ({time.perf_counter() - t1:.3f} s)")
    out = {}
    for part, fn in (
            ("a", lambda: lm_serve_small(torch, np, copy, serve, tfm,
                                         search_device, KnnSoftmaxHead,
                                         preset_config, smi, device)),
            ("b", lambda: lm_serve_full(torch, np, serve, tfm,
                                        KnnSoftmaxHead, preset_config, mods,
                                        smi, device)),
            ("c", lambda: lm_train_100m(torch, np, shutil, tfm, preset_config,
                                        pipeline, optimizer, checkpoint,
                                        trainer, make_train_step, param_tree,
                                        smi, device)),
            ("d", lambda: lm_train_full(torch, np, tfm, preset_config,
                                        pipeline, optimizer, make_train_step,
                                        param_tree, smi, device))):
        if part not in parts:
            continue
        # lint: allow-timing: each part ends on host results (synced)
        t1 = time.perf_counter()
        out[part] = fn()
        print(f"  [15{part}] {time.perf_counter() - t1:.3f} s")
    return out


def start_ranks(n: int, report: Path, gate: Path, stop_at: int,
                argv: list) -> tuple:
    """``train-rank`` (:func:`train_rank_child`) on ``n`` ranks under
    ``torchrun --standalone``, in a session of its own, started now; each
    rank imports and then waits for ``gate`` to exist before it calls
    ``main``.  Phase 17 starts its launches together and opens each gate
    when the launch before it has ended, so their start-up (the agent, the
    imports: 21–33 s a launch on an NVIDIA H100 80GB HBM3 machine at
    700.00 W) overlaps, and no two launches use the card at once."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", str(ROOT / "chip_smoke.py"),
           "train-rank", report, gate, stop_at] + argv
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([str(a) for a in cmd], env=env, cwd=str(ROOT),
                            text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, start_new_session=True)
    return proc, report, argv[:2], time.time()


def finish_ranks(launch: tuple, timeout: float, what: str) -> tuple:
    """Wait for a launch of :func:`start_ranks` (its whole session killed
    if it outlives ``timeout`` from its start); print where its time went;
    ``(standard output, rank 0's report)``.  Fails on a non-zero exit."""
    import signal
    proc, report, label, started = launch
    try:
        out, err = proc.communicate(
            timeout=max(timeout - (time.time() - started), 1.0))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"phase 17 {what}: {label} ran past {timeout} s")
    if proc.returncode != 0:
        print(err[-4000:])
        fail(f"phase 17 {what}: {label} exited {proc.returncode}")
    rep = json.loads(report.read_text())
    m = dict(rep["marks"], launch=started, exit=time.time())
    print(f"    launch of {label}: torchrun to the rank "
          f"{m['child'] - m['launch']:.3f} s, imports "
          f"{m['imported'] - m['child']:.3f} s, waiting its turn "
          f"{m['gate'] - m['imported']:.3f} s, process group, mesh, model "
          f"and placement {m['run'] - m['gate']:.3f} s, the trainer "
          f"{m['ran'] - m['run']:.3f} s ({sum(rep['step_s']):.3f} s of it in "
          f"steps), to the end of main {m['main_done'] - m['ran']:.3f} s, "
          f"exit {m['exit'] - m['main_done']:.3f} s")
    return out, rep


def train_rank_child(argv: list) -> None:
    """One ``torchrun`` rank of phase 17: once the file ``argv[1]`` exists,
    ``repro_torch.launch.train.main`` on ``argv[3:]`` under
    ``torch.use_deterministic_algorithms`` (warning only, as phase 15 (c)'s
    fallback allows); rank 0 writes its trainer's report (losses, step
    seconds, steps run, the step resumed from, whether a signal stopped
    it, wall-clock marks of the launch) as JSON to ``argv[0]``; every rank
    sends itself SIGTERM while the data of step ``argv[2]`` is drawn (none
    if negative)."""
    import signal
    # wall-clock marks of the launch (one host clock for every process)
    marks = {"child": time.time()}
    out, gate, stop_at, rest = argv[0], Path(argv[1]), int(argv[2]), argv[3:]
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.data import tokens
    from repro_torch.launch import train
    from repro_torch.train import trainer
    torch.use_deterministic_algorithms(True, warn_only=True)
    marks["imported"] = time.time()
    while not gate.exists():
        if time.time() - marks["child"] > RANK_TIMEOUT_S:
            sys.exit(f"train-rank: {gate} did not open")
        time.sleep(0.02)
    marks["gate"] = time.time()
    batch_at, run = tokens.TokenPipeline.batch_at, trainer.Trainer.run

    def drawn(self, step):
        if step == stop_at:
            os.kill(os.getpid(), signal.SIGTERM)      # preemption, to itself
        return batch_at(self, step)

    report = {}

    def recorded(self, model, opt_state):
        marks["run"] = time.time()
        model, opt_state, rep = run(self, model, opt_state)
        marks["ran"] = time.time()
        report.update(losses=rep.losses, step_s=rep.step_times,
                      steps_run=rep.steps_run, resumed_from=rep.resumed_from,
                      interrupted=rep.interrupted)
        return model, opt_state, rep
    tokens.TokenPipeline.batch_at, trainer.Trainer.run = drawn, recorded
    train.main(rest)
    marks["main_done"] = time.time()
    if os.environ.get("RANK", "0") == "0":
        Path(out).write_text(json.dumps(dict(report, marks=marks)))


def train_ranks_phase(np, shutil, lm_entry: dict, smi, cards: int) -> dict:
    """Phase 17 (a) and (b) on one rank and (c) on four cards (module
    docstring); ``lm_entry`` is phase 15's result, whose parts (c) and (d)
    (a) and (b) are held against; ``cards`` the visible count."""
    import signal
    root = ROOT / "build" / "phase17"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ckpt = root / "a"
    a = ["--preset", "100m", "--arch", "olmo-1b", "--steps", TRAIN_STEPS,
         "--batch", TRAIN_B, "--seq", TRAIN_S, "--ckpt-every", TRAIN_CKPT,
         "--ckpt-dir", ckpt, "--device", "cuda"]
    b = ["--preset", "full", "--arch", "olmo-1b", "--steps", RANK_FULL_STEPS,
         "--batch", FULL_B, "--seq", FULL_S, "--ckpt-every", 1000,
         "--ckpt-dir", root / "b", "--device", "cuda"]
    gates = [root / f"go{i}" for i in range(3)]
    # lint: allow-timing: each launch ends with its processes (host time)
    t1 = time.perf_counter()
    launches = [start_ranks(1, root / "a1.json", gates[0], TRAIN_CKPT - 1, a),
                start_ranks(1, root / "a2.json", gates[1], -1, a),
                start_ranks(1, root / "b.json", gates[2], -1, b)]
    gates[0].touch()
    try:
        out = train_ranks_checks(np, shutil, lm_entry, smi, root, ckpt,
                                 gates, launches, t1)
    finally:        # a launch still waiting on its gate when a check fails
        for proc, *_ in launches:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    out["c"] = train_two_hosts(smi, cards)
    return out


def train_two_hosts(smi, cards: int) -> dict:
    """Phase 17 (c): ``scripts/train_over_cards.py`` on the smoke preset,
    ``(2, 2)`` from two launchers against one card (module docstring);
    fails on any gate."""
    import signal
    if cards < 4:
        print(f"  (c) needs four cards, {cards} visible: not run")
        return {"cards": cards}
    cmd = [sys.executable, str(ROOT / "scripts" / "train_over_cards.py"),
           "--preset", "smoke", "--batch", HOSTS_B, "--seq", HOSTS_S,
           "--steps", HOSTS_STEPS, "--tol", "1e-4", "--meshes", "1x1,2x2",
           "--hosts", "2", "--timeout", RANK_TIMEOUT_S]
    # lint: allow-timing: the launches end with their processes (host time)
    t1 = time.perf_counter()
    proc = subprocess.Popen([str(a) for a in cmd], cwd=str(ROOT), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        log, err = proc.communicate(timeout=2 * RANK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"phase 17 (c) ran past {2 * RANK_TIMEOUT_S} s")
    secs = time.perf_counter() - t1
    lines = log.strip().splitlines()
    if proc.returncode != 0 or not lines:
        print(log[-6000:], err[-4000:])
        fail(f"phase 17 (c): train_over_cards.py exited {proc.returncode}")
    res = json.loads(lines[-1])
    ref, run = res["runs"]
    if not (res["ok"] and run["hosts"] == 2 and run["mesh"] == [2, 2]):
        fail(f"phase 17 (c): {res}")
    print(f"  (c) smoke on (2, 2) from two launchers (two hosts of two "
          f"cards), {HOSTS_STEPS} steps of {HOSTS_B} x {HOSTS_S}, against "
          f"one card drawing the same rows: rows {run['rows']}, the first "
          f"loss within {run['loss_rel']:.3g} (bound 1e-05), the gradients "
          f"within {run['grad_worst']:.3g} (bound 1e-4), each host's tokens "
          f"bitwise; in float64 the first loss within "
          f"{run['float64_loss_rel']:.3g} (bound 1e-12) and the gradients "
          f"within {run['float64_grad_worst']:.3g} (bound 1e-08); median "
          f"step {run['median_step_ms']:.3f} ms against "
          f"{ref['median_step_ms']:.3f} ms on one card; {secs:.3f} s [{smi}]")
    return {"loss_rel": run["loss_rel"], "grad_worst": run["grad_worst"],
            "float64_loss_rel": run["float64_loss_rel"],
            "float64_grad_worst": run["float64_grad_worst"],
            "step_ms_median": run["median_step_ms"],
            "one_card_step_ms_median": ref["median_step_ms"],
            "seconds": secs}


def train_ranks_checks(np, shutil, lm_entry, smi, root, ckpt, gates,
                       launches, t1) -> dict:
    """Phase 17's launches of :func:`train_ranks_phase`, run one after
    another through their gates, and the checks of (a) and (b)."""
    log1, first = finish_ranks(launches[0], RANK_TIMEOUT_S, "(a)")
    gates[1].touch()
    log2, second = finish_ranks(launches[1], RANK_TIMEOUT_S, "(a)")
    a_s = time.perf_counter() - t1
    out = {}
    heads = [ln for log in (log1, log2) for ln in log.splitlines()
             if ln.startswith("arch=")]
    if heads != ["arch=olmo-1b preset=100m params=67.1M mesh={'data': 1, "
                 "'model': 1}"] * 2:
        fail(f"phase 17 (a): header lines {heads}")
    if not (first["interrupted"] and first["steps_run"] == TRAIN_CKPT
            and second["resumed_from"] == TRAIN_CKPT
            and second["steps_run"] == TRAIN_STEPS - TRAIN_CKPT
            and not second["interrupted"]):
        fail(f"phase 17 (a): the stop and resume went wrong: {first} "
             f"{second}")
    names = sorted(p.name for p in ckpt.iterdir())
    losses = np.asarray(first["losses"] + second["losses"])
    want = np.asarray(lm_entry["c"]["losses"])
    if losses.shape != want.shape or not np.isfinite(losses).all():
        fail(f"phase 17 (a): losses {losses} against phase 15 (c)'s {want}")
    rel = float(np.max(np.abs(losses - want) / np.abs(want)))
    if rel > 1e-4:
        fail(f"phase 17 (a): losses {rel:.3g} from phase 15 (c)'s, beyond "
             f"rtol 1e-4")
    step_ms = float(np.median(first["step_s"][1:] + second["step_s"][1:])
                    ) * 1e3
    out["a"] = {"losses": losses.tolist(), "bitwise": bool(
        np.array_equal(losses, want)), "max_rel": rel,
        "step_ms_median": step_ms,
        "plain_step_ms_median": lm_entry["c"]["step_ms_median"],
        "checkpoints": names, "seconds": a_s}
    print(f"  (a) 100m on one NCCL rank (mesh (1, 1)): SIGTERM at step "
          f"{TRAIN_CKPT - 1}'s data, {first['steps_run']} steps, then "
          f"resumed_from={second['resumed_from']} to {TRAIN_STEPS}; "
          f"checkpoints {names}; the {len(losses)} losses "
          f"{'bitwise' if out['a']['bitwise'] else f'within {rel:.3g}'} "
          f"phase 15 (c)'s; median step {step_ms:.3f} ms (phase 15 (c), "
          f"plain: {out['a']['plain_step_ms_median']:.3f} ms); the two "
          f"launches {a_s:.3f} s [{smi}]")

    t1 = time.perf_counter()
    gates[2].touch()
    log, rep = finish_ranks(launches[2], RANK_TIMEOUT_S, "(b)")
    b_s = time.perf_counter() - t1
    head = [ln for ln in log.splitlines() if ln.startswith("arch=")]
    if head != ["arch=olmo-1b preset=full params=1279.8M mesh={'data': 1, "
                "'model': 1}"] or rep["steps_run"] != RANK_FULL_STEPS or \
            not np.isfinite(rep["losses"]).all():
        fail(f"phase 17 (b): {head} {rep}")
    if any((root / "b").iterdir()):
        fail("phase 17 (b) wrote a checkpoint")
    ms = [t * 1e3 for t in rep["step_s"]]
    d = lm_entry["d"]
    out["b"] = {"step_ms": ms, "losses": rep["losses"],
                "plain_step_ms": d["step_ms"],
                "step_bound_ms": d["step_bound_ms"], "seconds": b_s}
    print(f"  (b) olmo-1b full width on one NCCL rank (mesh (1, 1)), "
          f"{RANK_FULL_STEPS} steps of {FULL_B} x {FULL_S}: "
          f"{[round(x, 3) for x in ms]} ms (phase 15 (d), plain: "
          f"{[round(x, 3) for x in d['step_ms']]} ms; bound "
          f"{d['step_bound_ms']:.3f} ms); loss {rep['losses']}; after (a), "
          f"{b_s:.3f} s [{smi}]")
    shutil.rmtree(root, ignore_errors=True)
    return out


def dryrun_start(out_dir: Path, device: str = "cuda"
                 ) -> list[subprocess.Popen]:
    """Phase 16 (a), started in the background: ``launch.dryrun`` on the
    16 x 16 production mesh (a fake process group of 256 ranks, fake CUDA
    tensors) for OLMo-1B's train_4k and decode_32k and eight Dumpy cells
    in one child, ``DRYRUN_CELLS`` in another."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    common = ["--mesh", "single", "--out", str(out_dir), "--device", device]
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    # each child's output to its own file: two pipes read one after the
    # other could fill and stall the child read second
    for i, which in enumerate((
            ["--arch", "olmo-1b,dumpy", "--shape", ",".join(DRYRUN_SHAPES),
             "--kinds", ",".join(DRYRUN_KINDS)],
            ["--cells", ",".join(DRYRUN_CELLS)])):
        with open(out_dir / f"child{i}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *which,
                 *common], env=env, cwd=str(ROOT), stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def dryrun_cells(torch, procs: list, out_dir: Path, smi) -> dict:
    """Phase 16 (a), collected: every record without ``error`` or a skip,
    its bottleneck, step bound, GiB a device and loop trip counts
    printed; each LM cell's peak beside the card's memory, and none above
    it."""
    # lint: allow-timing: the children count on the host
    deadline = time.perf_counter() + DRYRUN_TIMEOUT_S
    for i, proc in enumerate(procs):
        try:
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
            fail(f"the dry run took over {DRYRUN_TIMEOUT_S} s")
        if proc.returncode != 0:
            log = (out_dir / f"child{i}.log").read_text()
            fail(f"the dry run failed ({proc.returncode}): {log[-2000:]}")
    out = {}
    lm = [f"olmo-1b__{s}__pod_16x16" for s in DRYRUN_SHAPES] + \
        [f"{c.replace(':', '__')}__pod_16x16" for c in DRYRUN_CELLS]
    tags = lm + [f"dumpy-{k}__pod_16x16" for k in DRYRUN_KINDS]
    for tag in tags:
        path = out_dir / f"{tag}.json"
        if not path.exists():
            fail(f"the dry run wrote no record {path.name}")
        rec = json.loads(path.read_text())
        if "error" in rec or "skipped" in rec:
            fail(f"dry run {tag}: {rec.get('error') or rec.get('skipped')}")
        r = rec["roofline"]
        gib = rec["memory"]["peak_per_device"] / 2**30
        loops = rec["cost"]["loops"]
        out[tag] = dict(bottleneck=r["bottleneck"], step_s=r["step_s"],
                        gib_per_device=gib,
                        peak_bytes=rec["memory"]["peak_per_device"],
                        analyze_s=rec["compile_s"],
                        flops=rec["cost"]["flops_per_device"],
                        collective_bytes=rec["collectives"]["total_bytes"],
                        loops=loops)
        print(f"  (a) {tag}: bottleneck {r['bottleneck']}, step bound "
              f"{r['step_s'] * 1e3:.4f} ms (compute {r['compute_s'] * 1e3:.4f}"
              f" / memory {r['memory_s'] * 1e3:.4f} / collective "
              f"{r['collective_s'] * 1e3:.4f} ms), {gib:.3f} GiB a device, "
              f"loops by trip count {loops or 'none'}, counted in "
              f"{rec['compile_s']} s")
    for kind in ("search_sharded", "search_dtw"):
        if not out[f"dumpy-{kind}__pod_16x16"]["loops"]:
            fail(f"dry run dumpy-{kind}: no loop counted by its trips")
    if not out["xlstm-1.3b__train_4k__pod_16x16"]["loops"]:
        fail("dry run xlstm-1.3b train_4k: no loop counted by its trips")
    total = (torch.cuda.get_device_properties(0).total_memory
             if torch.cuda.is_available() else None)
    for tag in lm:
        peak = out[tag]["peak_bytes"]
        print(f"  (a) {tag}: peak {peak} B a device "
              f"({out[tag]['gib_per_device']:.3f} GiB) against the card's "
              f"total_memory {total} B")
        if total is not None and peak > total:
            fail(f"dry run {tag}: its peak {peak} B a device is over the "
                 f"card's {total} B")
    print(f"  (a) bounds from data-sheet peaks at 700 W; card here: {smi}")
    return out


def dryrun_one_device(torch, np, smi, device: str = "cuda") -> dict:
    """Phase 16 (b): the dry run on a 1 x 1 mesh against the card: the
    ``100m`` train step at 8 x 512, OLMo-1B's decode step at B 4 over a
    64-position cache, its prefill at phase 14 (b)'s 4 x 2048, and reduced
    xLSTM's train step at 8 x 512 (its loops counted by trip, the backward
    too).  Each: the dry run's FLOPs equal ``FlopCounterMode`` over the
    real step, its peak beside ``max_memory_allocated`` over the step, and
    the measured step no faster than the dry run's bound."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import RunShape, reduced
    from repro_torch.data.tokens import (TokenPipeline,
                                         TokenPipelineConfig)
    from repro_torch.distributed import op_cost, roofline, sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import preset_config
    from repro_torch.models import registry, transformer as tfm
    from repro_torch.models.weights import param_tree
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def predicted(cfg, shape):
        with sharding.fake_world(1):
            mesh = sharding.named_mesh((1, 1), ("data", "model"), device)
            rules = dryrun.rules_for(cfg, shape, mesh)
            step, args = dryrun.cell_program(cfg, shape, mesh, rules, device)
            with dryrun.traced(mesh, rules):
                cost = op_cost.analyze(step, *args)
            del step, args
        rl = roofline.analyze(
            flops_per_device=cost.flops, bytes_per_device=cost.hbm_bytes,
            collective_bytes_per_device=cost.collective_bytes, n_devices=1,
            model_flops=0.0, flops_by_dtype=cost.flops_by_dtype,
            inter_host_bytes=cost.inter_host_bytes)
        return cost, rl

    def measure(run, n=DRYRUN_STEPS):
        run()                                          # warm
        sync()
        ms = []
        for _ in range(n):
            # lint: allow-timing: sync() is torch.cuda.synchronize on the
            # card
            t1 = time.perf_counter()
            run()
            sync()
            ms.append((time.perf_counter() - t1) * 1e3)
        return float(np.median(ms))

    out = {}
    for label, cfg, shape in (
            ("100m train", preset_config("olmo-1b", "100m"),
             RunShape("100m", TRAIN_S, TRAIN_B, "train")),
            ("olmo-1b decode", registry.get_config("olmo-1b"),
             RunShape("serve", SERVE_P + SERVE_T, SERVE_B, "decode")),
            ("olmo-1b prefill", registry.get_config("olmo-1b"),
             RunShape("prefill", OLMO_S, OLMO_B, "prefill")),
            ("xlstm reduced train", reduced(registry.get_config("xlstm-1.3b")),
             RunShape("xlstm", TRAIN_S, TRAIN_B, "train"))):
        # lint: allow-timing: the dry run runs on the host (fake tensors)
        t1 = time.perf_counter()
        cost, rl = predicted(cfg, shape)
        t_dry = time.perf_counter() - t1
        if cuda:
            torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated() if cuda else 0
        model = tfm.init_params(cfg, torch.Generator(device).manual_seed(0),
                                device)
        if shape.kind == "train":
            ocfg = dryrun.adamw_for(cfg)
            state = opt.init(param_tree(model), ocfg)
            pipe = TokenPipeline(TokenPipelineConfig(
                vocab=cfg.vocab, seq_len=shape.seq_len,
                global_batch=shape.global_batch))
            batch = pipe.batch_at(0)
            step = make_train_step(cfg, ocfg)

            def run():
                step(model, state, batch)
        elif shape.kind == "prefill":
            prefill = torch.no_grad()(registry.make_prefill_step(cfg))
            tokens = torch.from_numpy(np.random.default_rng(0).integers(
                0, cfg.vocab, (shape.global_batch, shape.seq_len),
                dtype=np.int32)).to(device)

            def run():
                prefill(model, {"tokens": tokens})
        else:
            caches = tfm.init_cache(cfg, shape.global_batch, shape.seq_len,
                                    device)
            token = torch.zeros((shape.global_batch, 1), dtype=torch.int32,
                                device=device)

            @torch.no_grad()
            def run():
                tfm.forward_decode(model, caches, token, shape.seq_len - 1)
        run()
        sync()
        with FlopCounterMode(display=False) as fc:
            run()
        real_flops = fc.get_total_flops()
        sync()
        peak = None
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            run()
            sync()
            peak = torch.cuda.max_memory_allocated() - base
        ms = measure(run)
        bound_ms = rl.step_s * 1e3
        row = dict(flops_dryrun=cost.flops, flops_card=real_flops,
                   flops_by_dtype=cost.flops_by_dtype,
                   hbm_bytes=cost.hbm_bytes, peak_dryrun=cost.peak_bytes,
                   peak_card=peak,
                   peak_ratio=cost.peak_bytes / peak if peak else None,
                   step_ms=ms, bound_ms=bound_ms,
                   bottleneck=rl.bottleneck, measured_over_bound=ms / bound_ms,
                   dryrun_s=t_dry, loops=cost.loops)
        out[label] = row
        extra = (f", PERF.md's hand bound {OLMO_DECODE_HAND_BOUND_MS} ms"
                 if shape.kind == "decode" else "")
        if cost.loops:
            extra += f", loops counted by trip {cost.loops}"
        print(f"  (b) {label} [{shape.global_batch} x {shape.seq_len}] on a "
              f"1 x 1 mesh: FLOPs {cost.flops:.6e} (dry run) vs "
              f"{real_flops:.6e} (FlopCounterMode over the step on the "
              f"card); peak {cost.peak_bytes} B predicted vs {peak} B "
              f"max_memory_allocated (ratio {row['peak_ratio']}); step "
              f"{ms:.4f} ms measured vs dry-run bound {bound_ms:.6f} ms "
              f"({rl.bottleneck}){extra}; measured / bound "
              f"{ms / bound_ms:.2f} (dry run {t_dry:.1f} s) [{smi}]")
        if cost.flops != real_flops:
            fail(f"{label}: the dry run counts {cost.flops} FLOPs, the "
                 f"card's step {real_flops}")
        if label.startswith("xlstm") and not cost.loops:
            fail(f"{label}: the dry run counted no loop by its trips")
        if ms < bound_ms:
            fail(f"{label}: the step took {ms:.4f} ms, under its dry-run "
                 f"bound {bound_ms:.4f} ms")
        del model, run
        if shape.kind == "train":
            del state, step
        elif shape.kind == "decode":
            del caches
        if cuda:
            torch.cuda.empty_cache()
    return out


def dryrun_exact(torch, sd, index, dev, batches, dtw_batches,
                 census: dict, n_series: int, smi) -> dict:
    """Phase 16 (b)'s exact cells on the resident layout ``dev`` (run after
    phase 13; phase 14 frees it): ``lower_exact_on`` over fake copies of
    ``dev`` on a 1 x 1 mesh, ED and DTW ``cluster`` at batch 64, each
    against phase 13 (d)'s ``census`` of a real batch and one real batch
    timed here.  ED: ``pairwise_l2`` once a span of the layout, as many as
    the census saw (every span runs there), ``lb_paa_interval`` as many,
    the batch no faster than the bound.  DTW: each of its three kernels at
    least the census's; its bound counts every walk chunk, the worst case:
    more work than a batch whose walk stops early does, so no floor on its
    time, and printed as the worst case, not gated.  Both: the predicted
    peak printed beside ``max_memory_allocated`` (not gated)."""
    from repro_torch.core import distributed as D
    from repro_torch.core.metric import resolve
    from repro_torch.distributed import roofline

    cuda = dev.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    W = dev.win_start.shape[1]
    kk = sd._result_margin(dev, K) + 8
    out = {}
    for label, qb, kw in (
            ("exact ED", batches[0], dict(metric="ed")),
            ("exact DTW cluster", dtw_batches[0],
             dict(metric="dtw", band=BAND, order="cluster"))):
        met = resolve(kw["metric"], LENGTH, kw.get("band"), kw.get("order"))
        # lint: allow-timing: the count runs on the host (fake tensors)
        t1 = time.perf_counter()
        cost = D.lower_exact_on(dev, k=kk, q_batch=len(qb),
                                metric=met).analyze()
        t_dry = time.perf_counter() - t1
        rl = roofline.analyze(
            flops_per_device=cost.flops, bytes_per_device=cost.hbm_bytes,
            collective_bytes_per_device=0.0, n_devices=1,
            model_flops=2.0 * BATCH * n_series * LENGTH,
            flops_by_dtype=cost.flops_by_dtype, inter_host_bytes=0.0)
        sync()
        base = torch.cuda.memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        # lint: allow-timing: the batch ends on host results
        t1 = time.perf_counter()
        sd.exact_search_device_batch(index, qb, K, chunk=CHUNK, dev=dev,
                                     **kw)
        sync()
        ms = (time.perf_counter() - t1) * 1e3
        peak = torch.cuda.max_memory_allocated() - base if cuda else None
        dry = {n: e["calls"] for n, e in cost.kernels.items()}
        real = census[label]["kernel_calls"]
        bound_ms = rl.step_s * 1e3
        temp = cost.peak_bytes - cost.argument_bytes
        # ED's bound is a floor (every span runs); DTW's the worst case
        floor = label == "exact ED"
        what = "bound" if floor else "worst-case bound"
        out[label] = dict(
            loops=cost.loops, calls_dryrun=dry, calls_census=real,
            flops=cost.flops, hbm_bytes=cost.hbm_bytes,
            flops_by_dtype=cost.flops_by_dtype, bound_ms=bound_ms,
            bound_is_floor=floor, bottleneck=rl.bottleneck, batch_ms=ms,
            measured_over_bound=ms / bound_ms,
            peak_over_layout_dryrun=temp, peak_over_resident_card=peak,
            dryrun_s=t_dry)
        print(f"  (b) {label} [{len(qb)} x {dev.db.shape[1]} x {LENGTH}] on "
              f"a 1 x 1 mesh over fake copies of the resident layout: loops "
              f"{cost.loops}; kernel calls {dry} (dry run, every trip) vs "
              f"{real} (phase 13 (d) census); {what} {bound_ms:.6f} ms "
              f"({rl.bottleneck}; compute {rl.compute_s * 1e3:.6f} / memory "
              f"{rl.memory_s * 1e3:.6f} ms), one batch {ms:.3f} ms, "
              f"measured / {what} {ms / bound_ms:.2f}; peak above the layout "
              f"{temp} B predicted vs {peak} B max_memory_allocated above "
              f"the resident (gap {None if peak is None else peak - temp} B, "
              f"not gated) (dry run {t_dry:.1f} s) [{smi}]")
        if label == "exact ED":
            if cost.loops != {"span": W} or dry["pairwise_l2"] != W:
                fail(f"exact ED dry run: loops {cost.loops}, "
                     f"{dry['pairwise_l2']} pairwise_l2 calls for {W} spans")
            for name in ("pairwise_l2", "lb_paa_interval"):
                if dry[name] != real.get(name):
                    fail(f"exact ED dry run: {dry[name]} {name} calls, the "
                         f"census of a real batch {real.get(name)}")
            if ms < bound_ms:
                fail(f"{label}: a batch took {ms:.3f} ms, under its dry-run "
                     f"bound {bound_ms:.6f} ms")
        else:
            for name in ("lb_keogh", "lb_improved", "dtw_band"):
                if dry.get(name, 0) < real.get(name, 0) or not dry.get(name):
                    fail(f"exact DTW dry run: {dry.get(name)} {name} calls, "
                         f"under the census's {real.get(name)}")
    return out


def dryrun_kernels(torch, rows, distributed, n_series: int, smi,
                   device: str = "cuda") -> dict:
    """Phase 16 (b)'s search cell and (c): ``lower_search_oneshot`` on a
    1 x 1 mesh at ``[64, n_series, 256]``, whose ``pairwise_l2`` term must
    equal this run's bound of phase 12 (c)'s call within 1% and be no more
    than its time; each kernel's ``abstract`` work at its main shape
    (phases 4 and 7: ``rows``) within 1% of that bound, the time measured
    there no less than it."""
    from types import SimpleNamespace

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import distributed as D
    from repro_torch.distributed import op_cost, roofline
    from repro_torch.kernels import ops

    out = {}
    one = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    cost = D.lower_search_oneshot(one, n_series=n_series, length=LENGTH,
                                  w=16, k=50, q_batch=BATCH,
                                  device=device).analyze()
    k = cost.kernels["pairwise_l2"]
    s, by = roofline.kernel_bound_s(k["flops"], k["bytes"])
    want, ms = distributed["pairwise_l2_bound_ms"], distributed[
        "pairwise_l2_ms"]
    out["search"] = dict(pairwise_l2_bound_ms=s * 1e3, phase12_bound_ms=want,
                         phase12_ms=ms, flops=cost.flops,
                         hbm_bytes=cost.hbm_bytes)
    print(f"  (b) search cell [{BATCH}, {n_series}, {LENGTH}] on a 1 x 1 "
          f"mesh: pairwise_l2 term {s * 1e3:.6f} ms ({by}) vs phase 12's "
          f"bound {want:.6f} ms; phase 12 measured {ms:.5f} ms [{smi}]")
    if abs(s * 1e3 - want) > 0.01 * want:
        fail(f"search cell: pairwise_l2 term {s * 1e3:.6f} ms is not within "
             f"1% of {want:.6f} ms")
    if ms < s * 1e3:
        fail(f"search cell: phase 12 measured {ms:.5f} ms under the bound")

    def fake(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    # the calls look ops.<name> up when they run: op_cost.analyze swaps in
    # the abstract functions
    byname = {r["name"]: r for r in rows}
    for name in ("sax_encode", "pairwise_l2", "lb_paa_interval", "lb_keogh",
                 "lb_improved", "dtw_band"):
        r = byname[name]
        with FakeTensorMode():
            if name == "sax_encode":
                B, n = r["shape"]
                args, call = (fake(B, n),), lambda x: ops.sax_encode(x, 16, 8)
            elif name == "pairwise_l2":
                Q, X, n = r["shape"]
                args = (fake(Q, n), fake(X, n))
                call = lambda *a: ops.pairwise_l2(*a)  # noqa: E731
            elif name == "lb_paa_interval":
                Q, L, w = r["shape"]
                args = (fake(Q, w), fake(Q, w), fake(L, w), fake(L, w))
                call = lambda *a: ops.lb_paa_interval(*a, LENGTH)  # noqa: E731
            elif name == "lb_keogh":
                Q, m, n = r["shape"]
                args = (fake(m, n), fake(Q, n), fake(Q, n))
                call = lambda *a: ops.lb_keogh(*a)  # noqa: E731
            elif name == "lb_improved":
                Q, m, n = r["shape"]
                args = (fake(m, n), fake(Q, n), fake(Q, n), fake(Q, n))
                call = lambda *a: ops.lb_improved(*a, BAND)  # noqa: E731
            else:
                Q, m, n, rr = r["wide"]["shape"]
                args = (fake(Q, n), fake(m, n),
                        fake(Q, m, dtype=torch.bool), fake(Q))
                call = lambda *a: ops.dtw_band(*a, rr)  # noqa: E731
        c = op_cost.analyze(call, *args)
        kk = c.kernels[name]
        s, by = roofline.kernel_bound_s(kk["flops"], kk["bytes"])
        ref_ms, ref_t = ((r["wide"]["bound_ms"], r["wide"]["ms"])
                         if name == "dtw_band" else (r["bound_ms"], r["ms"]))
        out[name] = dict(abstract_bound_ms=s * 1e3, bound_by=by,
                         table_bound_ms=ref_ms, measured_ms=ref_t)
        where = ("the wide path, every lane on" if name == "dtw_band"
                 else f"{list(r['shape'])}")
        print(f"  (c) {name} at {where}: abstract work {kk['flops']:.6e} "
              f"operations, {kk['bytes']:.6e} B -> bound {s * 1e3:.6f} ms "
              f"({by}) vs this run's bound {ref_ms:.6f} ms; measured "
              f"{ref_t:.5f} ms [{smi}]")
        if abs(s * 1e3 - ref_ms) > 0.01 * ref_ms:
            fail(f"{name}: abstract bound {s * 1e3:.6f} ms is not within 1% "
                 f"of {ref_ms:.6f} ms")
        if ref_t < s * 1e3:
            fail(f"{name}: measured {ref_t:.5f} ms under its abstract bound")
    return out


def dryrun_phase(torch, np, rows, distributed, n_series: int, smi,
                 proc: list, out_dir: Path,
                 exact: dict | None = None) -> dict:
    """Phase 16: the dry run, (b) and (c) while (a) runs in its own
    processes (killed if the phase fails first); ``exact`` is (b)'s exact
    cells, counted before phase 14 (:func:`dryrun_exact`)."""
    try:
        out = {"one_device": dryrun_one_device(torch, np, smi)}
        if exact is not None:
            out["exact"] = exact
        if rows is not None:
            out["kernels"] = dryrun_kernels(torch, rows, distributed,
                                            n_series, smi)
        out["cells"] = dryrun_cells(torch, proc, out_dir, smi)
    finally:
        for p in proc:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def layout_bytes(torch, dev) -> int:
    """Bytes of a ``DeviceIndex``'s tensors (its layout on the card)."""
    import dataclasses
    return sum(v.numel() * v.element_size()
               for v in (getattr(dev, f.name) for f in dataclasses.fields(dev))
               if isinstance(v, torch.Tensor))


class timed_calls:
    """Context manager: the seconds spent in ``module.name`` for each
    ``(module, name)`` while the block runs (the device synchronized at
    each call's end, so asynchronous work is charged to its call)."""

    def __init__(self, sync, *targets):
        self.sync, self.targets = sync, targets
        self.s = {name: 0.0 for _, name in targets}

    def __enter__(self):
        self.real = [getattr(m, name) for m, name in self.targets]
        for (m, name), fn in zip(self.targets, self.real):
            def call(*a, _fn=fn, _name=name, **kw):
                t = time.perf_counter()
                try:
                    # lint: allow-timing: self.sync() synchronizes the card
                    return _fn(*a, **kw)
                finally:
                    self.sync()
                    self.s[_name] += time.perf_counter() - t
            setattr(m, name, call)
        return self

    def __exit__(self, *exc):
        for (m, name), fn in zip(self.targets, self.real):
            setattr(m, name, fn)


def layout_digest(np, ix) -> dict:
    """What a backend comparison holds of an index, as SHA-256 digests: the
    tree JSON, the leaf layout, every routing array of ``ROUTING_FIELDS``;
    and its stats (``plans_evaluated`` apart: the backends count plans per
    row and per word group)."""
    import hashlib
    from repro_torch.core.index import _tree_to_json

    def sha(a) -> str:
        a = np.ascontiguousarray(a)
        return hashlib.sha256(f"{a.dtype}{a.shape}".encode()
                              + a.tobytes()).hexdigest()

    out = {"tree JSON": hashlib.sha256(json.dumps(
        _tree_to_json(ix.root)).encode()).hexdigest()}
    for f in ("order", "leaf_offsets", "leaf_sym", "leaf_card"):
        out[f"flat.{f}"] = sha(getattr(ix.flat, f))
    for f in ROUTING_FIELDS:
        out[f"routing_flat.{f}"] = sha(getattr(ix.routing_flat, f))
    out["stats"] = dict(vars(ix.stats))
    out["stats"].pop("plans_evaluated")
    return out


def host_build_child(DumpyIndex, db, params, parts: bool, conn) -> None:
    """A forked process's work: the host build of ``db``, sending through
    ``conn`` its seconds, its fuzzy step's, and its ``layout_digest`` or,
    with ``parts``, the pieces of the index (tree, leaf layout, PAA, SAX,
    stats; ``db`` stays with the parent) — or the error it raised."""
    import numpy as np
    from repro_torch.core import fuzzy
    try:
        with timed_calls(lambda: None, (fuzzy, "fuzzy_duplicates")) as tc:
            t = time.perf_counter()
            # lint: allow-timing: the host build, numpy alone
            ix = DumpyIndex.build(db, params)
            s = time.perf_counter() - t
        out = dict(build_s=s, fuzzy_s=tc.s["fuzzy_duplicates"])
        if parts:
            out["parts"] = (ix.root, ix.flat, ix.paa, ix.sax, ix.stats)
        else:
            out["digest"] = layout_digest(np, ix)
        conn.send(out)
    except BaseException as e:          # the parent reports it and fails
        conn.send(dict(error=repr(e)))
    finally:
        conn.close()


def host_search_child(hs, index, qs, nbrs, conn) -> None:
    """A forked process's work: for each query of ``qs``, the host
    ``route_to_leaf`` leaf, ``approximate_search`` and ``extended_search``
    at each of ``nbrs`` (ED, k = K) on ``index``, sent through ``conn`` with
    their seconds (or the error they raised)."""
    try:
        t = time.perf_counter()
        out = []
        for q in qs:
            paa, sax = hs._encode_query(index, q)
            out.append((hs.route_to_leaf(index, paa, sax).leaf_id,
                        hs.approximate_search(index, q, K)[:2],
                        {nbr: hs.extended_search(index, q, K, nbr)[:2]
                         for nbr in nbrs}))
        # lint: allow-timing: host numpy searches alone
        conn.send(dict(results=out, s=time.perf_counter() - t))
    except BaseException as e:          # the parent reports it and fails
        conn.send(dict(error=repr(e)))
    finally:
        conn.close()


def start_forked(target, *args) -> tuple:
    """``target(*args, conn)`` in a forked process (host numpy work beside
    this process's device work), its result read by a thread here as soon
    as it is sent (a large one takes seconds through the pipe):
    ``(process, reader thread, {"got": result})``.  Both are daemons, so a
    failing run stops them; ``finish_forked`` waits for the result."""
    ctx = multiprocessing.get_context("fork")
    recv, send = ctx.Pipe(duplex=False)
    child = ctx.Process(target=target, args=args + (send,), daemon=True)
    child.start()
    send.close()
    box: dict = {}

    def read() -> None:
        try:
            box["got"] = recv.recv()
        except EOFError:              # the process died without a word
            box["got"] = dict(error="no result (the process ended)")

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    return child, reader, box


def finish_forked(started: tuple, what: str) -> tuple[dict, float]:
    """The result of a ``start_forked``, and the seconds waited for it;
    fails the run where the process raised or sent nothing in time.  The
    process is left to exit; the caller joins it when it is done."""
    child, reader, box = started
    t = time.perf_counter()
    reader.join(SKEW_CHILD_TIMEOUT_S)
    # lint: allow-timing: a wait on another process's result, no device work
    wait_s = time.perf_counter() - t
    if "got" not in box:
        child.terminate()
        fail(f"{what}: the forked process sent nothing in "
             f"{SKEW_CHILD_TIMEOUT_S} s")
    if "error" in box["got"]:
        fail(f"{what}: the forked process raised {box['got']['error']}")
    return box["got"], wait_s


def skew_fuzzy_phase(torch, np, sd, hs, ops, ref, mods, DumpyIndex, params,
                     qs, n_series: int, rand: dict | None, floor, smi,
                     device: str = "cuda") -> tuple[dict, dict]:
    """Phase 18: Dumpy and Dumpy-Fuzzy on the skewed collection, parts
    (a)–(g), each printed with its seconds.  ``params`` is phase 3's
    ``DumpyParams``; ``rand`` holds phases 5 and 7's figures to print
    beside these (``None`` where they did not run).  Every check fails the
    run on a miss.  Returns ``(summary, {kernel: lb_paa_interval's new
    shapes})``; the caller frees nothing: every layout dies with this
    frame."""
    import dataclasses
    import tracemalloc
    from types import SimpleNamespace
    from repro_torch.core import build_device, fuzzy
    from repro_torch.core.lb import dtw_np
    from repro_torch.data import series
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak_reset():
        if cuda:
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() if cuda else None

    out = {}
    for m in mods.values():
        m.launches = 0

    # -- (a) the collection --------------------------------------------------
    t1 = time.perf_counter()
    tracemalloc.start()
    db = series.clustered_series(n_series, LENGTH, n_clusters=SKEW_CLUSTERS,
                                 seed=SKEW_SEED)
    host_peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    gen_s = time.perf_counter() - t1
    sizes = np.bincount(series.cluster_assignment(
        n_series, SKEW_CLUSTERS, SKEW_SEED), minlength=SKEW_CLUSTERS)
    if not np.isfinite(db).all() or db.shape != (n_series, LENGTH):
        fail(f"clustered_series gave {db.shape}, or a non-finite value")
    out["data"] = dict(gen_s=gen_s, host_peak_bytes=host_peak,
                       largest_cluster_share=float(sizes.max() / n_series),
                       clusters_nonempty=int((sizes > 0).sum()))
    print(f"  (a) clustered_series({n_series}, {LENGTH}, n_clusters="
          f"{SKEW_CLUSTERS}, seed={SKEW_SEED}) in {gen_s:.3f} s, peak "
          f"{host_peak} host bytes (tracemalloc; the result alone "
          f"{db.nbytes}); the largest cluster holds "
          f"{sizes.max() / n_series:.7f} of the rows, "
          f"{int((sizes > 0).sum())} of {SKEW_CLUSTERS} clusters non-empty")

    # -- (b) builds ----------------------------------------------------------
    t1 = time.perf_counter()
    p_fz = dataclasses.replace(params, fuzzy_f=SKEW_FUZZY_F,
                               max_replica=SKEW_MAX_REPLICA)
    builds = {}
    # the host builds (Dumpy-Fuzzy's, sending the digests of its layout,
    # and plain Dumpy's, sending the index) run in forked processes while
    # this one builds Dumpy-Fuzzy on the device
    fz_host = start_forked(host_build_child, DumpyIndex, db, p_fz, False)
    pl_host = start_forked(host_build_child, DumpyIndex, db, params, True)
    with timed_calls(sync, (fuzzy, "fuzzy_duplicates"),
                     (build_device, "_encode"),
                     (build_device, "_lexsort_words")) as tc:
        sync()
        t2 = time.perf_counter()
        fz = DumpyIndex.build(db, p_fz, backend="device", device=device)
        sync()
        dev_s = time.perf_counter() - t2
    split_s = dict(tc.s)
    t2 = time.perf_counter()
    want = layout_digest(np, fz)
    digest_s = time.perf_counter() - t2
    got, wait_s = finish_forked(fz_host, "Dumpy-Fuzzy's host build")
    for key, value in want.items():
        if got["digest"][key] != value:
            fail(f"Dumpy-Fuzzy: the backends' layouts differ in {key}")
    print(f"  (b) Dumpy-Fuzzy (fuzzy_f {SKEW_FUZZY_F}, max_replica "
          f"{SKEW_MAX_REPLICA}): host build {got['build_s']:.3f} s in a "
          f"forked process (fuzzy step {got['fuzzy_s']:.3f} s), device build "
          f"{dev_s:.3f} s beside it (encode {split_s['_encode']:.3f} s, word "
          f"sort {split_s['_lexsort_words']:.3f} s, fuzzy step "
          f"{split_s['fuzzy_duplicates']:.3f} s), digests {digest_s:.3f} s, "
          f"then {wait_s:.3f} s waiting for the host build: the SHA-256 of "
          f"the tree JSON, flat.order, flat.leaf_offsets, the leaf symbols, "
          f"every routing array and the stats (n_duplicates "
          f"{want['stats']['n_duplicates']}) equal between the backends")
    builds["fuzzy"] = dict(host_build_s=got["build_s"],
                           host_fuzzy_s=got["fuzzy_s"],
                           device_build_s=dev_s,
                           device_encode_s=split_s["_encode"],
                           device_sort_s=split_s["_lexsort_words"],
                           device_fuzzy_s=split_s["fuzzy_duplicates"],
                           digest_s=digest_s, wait_s=wait_s)
    got, wait_s = finish_forked(pl_host, "Dumpy's host build")
    root, flat, paa, sax, stats = got["parts"]
    pl = DumpyIndex(params, root, flat, db, paa, sax, stats)
    builds["plain"] = dict(host_build_s=got["build_s"], wait_s=wait_s)
    print(f"  (b) Dumpy: host build {got['build_s']:.3f} s in a forked "
          f"process, then {wait_s:.3f} s waiting for it")
    layouts = {"plain": pl, "fuzzy": fz}
    devs = {}
    for label, ix in layouts.items():
        t2 = time.perf_counter()
        dv = devs[label] = ix.device_index(chunk=CHUNK, device=device)
        sync()
        up_s = time.perf_counter() - t2
        size = np.diff(ix.flat.leaf_offsets)
        st = ix.stats
        row = dict(leaves=ix.flat.n_leaves, height=st.height,
                   nodes=ix.routing_flat.n_nodes,
                   fill_factor=st.fill_factor, leaf_max=int(size.max()),
                   leaf_p99=float(np.percentile(size, 99)),
                   leaf_median=float(np.median(size)),
                   n_duplicates=st.n_duplicates,
                   total_rows=int(len(ix.flat.order)), lmax=dv.lmax,
                   layout_bytes=layout_bytes(torch, dv), upload_s=up_s)
        builds[label].update(row)
        built_s = builds[label].get("device_build_s",
                                    builds[label]["host_build_s"])
        print(f"  (b) {label}: {row['leaves']} leaves, height {st.height}, "
              f"{row['nodes']} nodes, fill factor {st.fill_factor:.7f}; "
              f"leaf size max {row['leaf_max']}, p99 {row['leaf_p99']:.1f}, "
              f"median {row['leaf_median']:.1f}; n_duplicates "
              f"{st.n_duplicates}, total rows {row['total_rows']}; lmax "
              f"{dv.lmax}; layout {row['layout_bytes']} bytes on the "
              f"{device} ({up_s:.3f} s to place); build "
              f"{built_s:.3f} s")
        if dv.has_duplicates != (label == "fuzzy"):
            fail(f"{label}: has_duplicates is {dv.has_duplicates}")
    out["builds"] = builds
    print(f"  (b) {time.perf_counter() - t1:.3f} s")

    # the host searches that (d) holds the card's against run in a forked
    # process while (c) runs on the card
    ed_b = [qs[i:i + BATCH] for i in range(0, SKEW_ED_QUERIES, BATCH)]
    host_search = start_forked(host_search_child, hs, fz, ed_b[0], NBRS)

    # the collection itself, for the float64 checks: row i is id i
    x = torch.from_numpy(db).to(device)
    coll = SimpleNamespace(
        db=[x], ids=[torch.arange(n_series, dtype=torch.int32,
                                  device=device)],
        alive=[torch.ones(n_series, dtype=torch.bool, device=device)])

    # -- (c) exact ED and DTW on both layouts --------------------------------
    t1 = time.perf_counter()
    # cut on four cards or more, where phase 17 (c) adds its launches
    dtw_q = SKEW_DTW_QUERIES // (2 if device == "cuda"
                                 and torch.cuda.device_count() >= 4 else 1)
    dtw_b = ed_b[0][:dtw_q]
    exact, figures = {}, {}
    for label, ix in layouts.items():
        for metric, bs in (("ED", ed_b), ("DTW", [dtw_b])):
            kw = {} if metric == "ED" else dict(metric="dtw", band=BAND)
            peak_reset()
            sync()
            t2 = time.perf_counter()
            res = [sd.exact_search_device_batch(ix, qb, K, chunk=CHUNK,
                                                return_stats=True,
                                                device=device, **kw)
                   for qb in bs]
            el = time.perf_counter() - t2
            exact[(label, metric)] = [(r[0], r[1]) for r in res]
            vis = np.concatenate([r[2] for r in res])
            figures[(label, metric)] = dict(
                qps=sum(map(len, bs)) / el, visited=float(vis.mean()),
                host_syncs=sum(r[3]["host_syncs"] for r in res),
                peak_bytes=peak(), s=el,
                counters={c: sum(r[3][c] for r in res) for c in res[0][3]
                          if c != "host_syncs" and metric == "DTW"})
    search_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    tied = 0
    for bi_, qb in enumerate(ed_b):
        bd, bi = brute_force(torch, coll, torch.from_numpy(qb).to(device), K)
        bd, bi = bd.cpu().numpy(), bi.cpu().numpy()
        for label in layouts:
            ids, d = exact[(label, "ED")][bi_]
            tied += check_exact(
                np, ids, d, bd, bi,
                lambda qi, i, qb=qb: np.sqrt(((db[i].astype(np.float64)
                                               - qb[qi].astype(np.float64))
                                              ** 2).sum()), K)
        ok, gap = ties_only(np, *exact[("fuzzy", "ED")][bi_],
                            *exact[("plain", "ED")][bi_])
        if not ok:
            fail(f"exact ED batch {bi_}: Dumpy-Fuzzy differs from Dumpy "
                 f"beyond ties (max rel {gap:.3e})")
    ids_f, d_f = exact[("fuzzy", "DTW")][0]
    bd, bi, dp_rows = dtw_float64_check(
        torch, coll, torch.from_numpy(dtw_b).to(device), d_f, BAND, K)
    bd, bi = bd.cpu().numpy(), bi.cpu().numpy()
    for label in layouts:
        tied += check_exact(np, *exact[(label, "DTW")][0], bd, bi,
                            lambda qi, i: dtw_np(dtw_b[qi], db[i], BAND), K)
    ok, gap = ties_only(np, ids_f, d_f, *exact[("plain", "DTW")][0])
    if not ok:
        fail(f"exact DTW: Dumpy-Fuzzy differs from Dumpy beyond ties (max "
             f"rel {gap:.3e})")
    for (label, metric), fg in figures.items():
        r = (rand or {}).get(metric)
        unit = "spans" if metric == "ED" else "gather chunks"
        print(f"  (c) exact {metric} on {label}: "
              f"{fg['qps']:.2f} qps, mean {unit} "
              f"visited {fg['visited']:.2f}, host syncs {fg['host_syncs']}, "
              f"peak {fg['peak_bytes']} bytes"
              + (f", cascade {fg['counters']}" if fg["counters"] else "")
              + (f" (Rand, phase {5 if metric == 'ED' else 7}: "
                 f"{r['qps']:.2f} qps, peak {r['peak_bytes']} bytes)"
                 if r else "") + f" [{smi}]")
    print(f"  (c) every exact batch (ED: {SKEW_ED_QUERIES} queries, DTW: "
          f"{dtw_q}, band {BAND}, order cluster) of both layouts "
          f"equal to "
          f"the float64 check over the collection (DTW's DP on {dp_rows} "
          f"(query, row) pairs), no repeated id, Dumpy-Fuzzy equal to Dumpy "
          f"up to ties; tied positions {tied}; searches {search_s:.3f} s, "
          f"checks {time.perf_counter() - t1:.3f} s")
    out["exact"] = {f"{m} {lb}": fg for (lb, m), fg in figures.items()}

    # -- (d) approximate and extended ----------------------------------------
    t1 = time.perf_counter()
    configs = ([("ED", "approximate", nbr) for nbr in NBRS]
               + [("ED", "extended", nbr) for nbr in NBRS]
               + [("DTW", "extended", SKEW_DTW_NBR)])
    runs, paths = {}, []
    for label, ix in layouts.items():
        for metric, path, nbr in configs:
            bs = ed_b if metric == "ED" else [dtw_b]
            kw = dict(nbr=nbr) if metric == "ED" else dict(
                nbr=nbr, metric="dtw", band=BAND)
            fn = (sd.approximate_search_device_batch if path == "approximate"
                  else sd.extended_search_device_batch)
            sync()
            t2 = time.perf_counter()
            res = [fn(ix, qb, K, device=device, **kw) for qb in bs]
            sync()
            ms = (time.perf_counter() - t2) * 1e3 / len(bs)
            runs[(label, metric, path, nbr)] = res
            truth = [r for r in exact[(label, metric)]]
            rec = float(np.mean([
                hs.average_precision(row, ex_row)
                for (ids, _, _), (ex_ids, _) in zip(res, truth)
                for row, ex_row in zip(ids, ex_ids)]))
            paths.append(dict(layout=label, metric=metric, path=path,
                              nbr=nbr, ms_a_batch=ms, recall=rec))
    for metric, path, nbr in configs:
        row = {x["layout"]: x for x in paths
               if (x["metric"], x["path"], x["nbr"]) == (metric, path, nbr)}
        print(f"  (d) {metric} {path} nbr={nbr}: recall@{K} (average "
              f"precision against (c)) Dumpy {row['plain']['recall']:.7f}, "
              f"Dumpy-Fuzzy {row['fuzzy']['recall']:.7f} (gain "
              f"{row['fuzzy']['recall'] - row['plain']['recall']:+.7f}); ms a "
              f"batch {row['plain']['ms_a_batch']:.3f} / "
              f"{row['fuzzy']['ms_a_batch']:.3f} [{smi}]")
    search_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    dv = devs["fuzzy"]
    # approximate nbr=1: the host route_to_leaf's leaf and the host
    # approximate_search's answer (each sums in its own order: ties at
    # rtol 1e-5); extended ED (re-ranked): bitwise the host extended_search
    got, host_wait_s = finish_forked(host_search, "the host searches")
    for i, (leaf, (h_ids, h_d), ext) in enumerate(got["results"]):
        ids, d, leaves = runs[("fuzzy", "ED", "approximate", 1)][0]
        if leaf != leaves[i, 0]:
            fail(f"Dumpy-Fuzzy approximate nbr=1 query {i}: leaf "
                 f"{leaves[i, 0]} is not the host route_to_leaf's")
        m = len(h_ids)
        ok, gap = ties_only(np, ids[i:i + 1, :m], d[i:i + 1, :m],
                            h_ids[None], h_d[None])
        if not ok or (ids[i, m:] != -1).any():
            fail(f"Dumpy-Fuzzy approximate nbr=1 query {i} differs from the "
                 f"host approximate_search (max rel {gap:.3e})")
        for nbr in NBRS:
            e_ids, e_d, _ = runs[("fuzzy", "ED", "extended", nbr)][0]
            h_ids, h_d = ext[nbr]
            m = len(h_ids)
            if not (np.array_equal(e_ids[i, :m], h_ids)
                    and np.array_equal(e_d[i, :m], h_d)
                    and (e_ids[i, m:] == -1).all()):
                fail(f"Dumpy-Fuzzy extended ED nbr={nbr} query {i} differs "
                     f"from the host extended_search")
    host_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    # every result: the float64 top-k over its scheduled leaves, each id once
    tied = 0
    for (label, metric, path, nbr), res in runs.items():
        if label != "fuzzy":
            continue
        bs = ed_b if metric == "ED" else [dtw_b]
        for qb, (ids, d, leaves) in zip(bs, res):
            q32 = torch.from_numpy(qb).to(device)
            rows_of = schedule_rows(torch, np, dv, leaves)
            if metric == "ED":
                bd, bi = brute_force(torch, dv, q32, K, rows_of)
                dist = (lambda qi, i, qb=qb: np.sqrt(
                    ((db[i].astype(np.float64)
                      - qb[qi].astype(np.float64)) ** 2).sum()))
            else:
                bd, bi, _ = dtw_float64_check(torch, dv, q32, d, BAND, K,
                                              rows_of)
                dist = lambda qi, i, qb=qb: dtw_np(qb[qi], db[i], BAND)
            tied += check_exact(np, ids, d, bd.cpu().numpy(),
                                bi.cpu().numpy(), dist, K)
    print(f"  (d) Dumpy-Fuzzy: approximate nbr=1 on the host route_to_leaf's "
          f"leaf and equal to the host approximate_search up to ties, "
          f"extended ED (re-ranked) bitwise the host extended_search at nbr "
          f"{NBRS} ({BATCH} queries); every configuration equal to the "
          f"float64 top-{K} over its scheduled leaves, each id once (tied "
          f"positions {tied}); searches {search_s:.3f} s, the host's "
          f"searches {got['s']:.3f} s in a forked process beside (c) "
          f"({host_wait_s:.3f} s waited for, {host_s:.3f} s with the "
          f"comparisons), float64 checks {time.perf_counter() - t1:.3f} s")
    out["paths"] = paths

    # -- (e) one 64-lane bucket, 25% DTW, one dead lane ----------------------
    t1 = time.perf_counter()
    out["bucket"] = bucket_parity(torch, np, sd, dtw_np, fz, dv, db, qs,
                                  ladder=(SERVE_LADDER[-1],))
    print(f"  (e) ({time.perf_counter() - t1:.3f} s)")

    # -- (f) tombstones: every replica of a deleted id dies ------------------
    t1 = time.perf_counter()
    ids_rows = dv.ids[0].cpu().numpy()
    copies = np.bincount(ids_rows[ids_rows >= 0], minlength=n_series)
    n_del = min(SKEW_TOMBSTONES, n_series // 4)
    top = np.unique(exact[("fuzzy", "ED")][0][0])
    top = top[top >= 0]
    rng = np.random.default_rng(SKEW_SEED)
    pool = np.setdiff1d(np.flatnonzero(copies > 1), top)
    victims = np.concatenate([top, rng.permutation(pool)])[:n_del]
    if len(victims) < n_del:
        rest = np.setdiff1d(np.arange(n_series), victims)
        victims = np.concatenate([victims, rng.permutation(rest)])[:n_del]
    for v in victims:
        fz.delete(int(v))
    dv_t = fz.device_index(chunk=CHUNK, device=device)
    hit = torch.isin(dv_t.ids[0], torch.from_numpy(victims).to(
        dv_t.ids[0].device, torch.int32))
    if (dv_t.alive[0] & hit).any():
        fail("a replica of a deleted id is still alive in the DeviceIndex")
    ids, d, _ = sd.exact_search_device_batch(fz, ed_b[0], K, chunk=CHUNK,
                                             device=device)
    if np.isin(ids, victims).any():
        fail("exact ED after delete returned a deleted id")
    live = torch.ones(n_series, dtype=torch.bool, device=device)
    live[torch.from_numpy(victims).to(device)] = False
    bd, bi = brute_force(torch, coll, torch.from_numpy(ed_b[0]).to(device),
                         K, live=live)
    tied = check_exact(np, ids, d, bd.cpu().numpy(), bi.cpu().numpy(),
                       lambda qi, i: np.sqrt(((db[i].astype(np.float64)
                                               - ed_b[0][qi].astype(
                                                   np.float64)) ** 2).sum()),
                       K)
    out["tombstones"] = dict(deleted=int(n_del),
                             rows_killed=int(hit.sum()),
                             replicated=int((copies[victims] > 1).sum()),
                             answers_deleted=int(len(top)))
    print(f"  (f) {n_del} ids deleted ({out['tombstones']['replicated']} of "
          f"them replicated, {len(top)} from batch 0's answers): "
          f"{int(hit.sum())} rows dead in the DeviceIndex, none alive; exact "
          f"ED batch 0 returns none of them and equals the float64 brute "
          f"force over the live rows (tied {tied}) "
          f"({time.perf_counter() - t1:.3f} s)")

    # -- (g) the kernels -----------------------------------------------------
    launches = {name: m.launches for name, m in mods.items()}
    out["launches"] = launches
    print(f"  (g) launches in phase 18: {launches}")
    if cuda:
        for name, n_l in launches.items():
            if n_l <= 0:
                fail(f"kernel {name} was not launched in phase 18")
    new_shapes = []
    if cuda:
        paa, _ = ops.sax_encode(torch.from_numpy(ed_b[0]).to(device), dv.w,
                                params.sax.b)
        w = dv.w
        for label, lo, hi in (("leaf table", dv.leaf_lo_g, dv.leaf_hi_g),
                              ("routing edges", dv.rt_lo, dv.rt_hi)):
            a = (paa, paa, lo, hi, LENGTH)
            lbpaa_bitwise(torch, ops, ref, a, f"Dumpy-Fuzzy {label}")
            ms, host = time_ms(torch, ops.lb_paa_interval, [a] * 20)
            plain, _ = time_ms(torch, ref.lb_paa_interval_ref, [a] * 20)
            Q, L = paa.shape[0], lo.shape[0]
            b_ms, b_by = bound(4 * (2 * Q * w + 2 * L * w + Q * L),
                               7 * Q * L * w + Q * L)
            new_shapes.append(dict(shape=[Q, L, w],
                                   path=f"Dumpy-Fuzzy {label} (18)", ms=ms,
                                   plain_ms=plain, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None))
            print(f"  (g) lb_paa_interval at the Dumpy-Fuzzy {label} "
                  f"[{Q},{L},{w}]: bitwise equal to the in-order sum; kernel "
                  f"{ms:.5f} ms (host {host:.4f} ms a call; launch floor "
                  f"{floor:.5f} ms), twin {plain:.5f} ms, bound {b_ms:.6f} ms "
                  f"({b_by}) [{smi}]")
    for child, _, _ in (fz_host, pl_host, host_search):
        child.join(60)
    return out, {"lb_paa_interval": new_shapes}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-series", type=int, default=4_000_000,
                    help="collection size (default: the paper-scale 4 M)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lm-only", action="store_true",
                    help="run phases 1, 14 and 15 alone (prints no ok line)")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="run phases 1 and 16 alone, without the kernel "
                         "rows of phases 4, 7 and 12 (prints no ok line)")
    ap.add_argument("--train-ranks-only", action="store_true",
                    help="run phases 1, 15 (c) and (d) and 17 alone (prints "
                         "no ok line)")
    ap.add_argument("--search-only", action="store_true",
                    help="run phases 1-13, 16 (b)'s exact cells and 18, "
                         "the search slice, alone (prints no ok line)")
    ap.add_argument("--skew-only", action="store_true",
                    help="run phases 1, 2 and 18 alone (prints no ok line)")
    args = ap.parse_args()

    # phase 15 (c) compares two training runs under deterministic
    # algorithms, which cuBLAS allows only with this set before it starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one NVIDIA GPU")
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the repro_torch package is missing under {src}")
    sys.path.insert(0, str(src))
    import numpy as np
    from repro_torch.core.build import DumpyParams
    from repro_torch.core.build_device import device_build
    from repro_torch.core.index import DumpyIndex
    from repro_torch.core.lb import (dtw2_masked_gather, dtw_envelope_batch,
                                     dtw_np)
    from repro_torch.core.metric import query_prep, resolve
    from repro_torch.core.sax import SaxParams, breakpoints
    from repro_torch.core import distributed as dist
    from repro_torch.core import search, search_device
    from repro_torch.core.baselines import isax2plus, tardis
    from repro_torch.distributed import sharding
    from repro_torch.core.search_device import exact_search_device_batch
    from repro_torch.core.split import SplitParams
    from repro_torch.data.series import query_workload, random_walks
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import (dtw_band, lb_improved, lb_isax, lb_keogh,
                                     pairwise_l2, sax_encode)
    from repro_torch.serving.batching import CoalescingFrontend, ServingStats
    from repro_torch.serving.knn_softmax import KnnSoftmaxHead
    from repro_torch.robustness import failpoints
    from repro_torch.robustness import smoke as robustness_smoke

    # ---- 1. environment -------------------------------------------------
    t_run = t0 = time.perf_counter()
    smi = nvidia_smi()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}"
          f", {torch.cuda.device_count()} visible")
    phase("environment", t0)
    mods = {"sax_encode": sax_encode, "pairwise_l2": pairwise_l2,
            "lb_paa_interval": lb_isax, "lb_keogh": lb_keogh,
            "lb_improved": lb_improved, "dtw_band": dtw_band}
    if args.lm_only:
        t0 = time.perf_counter()
        print(json.dumps({"lm": lm_phase(torch, np, args.seed, smi)}))
        phase("LM substrate", t0)
        t0 = time.perf_counter()
        print(json.dumps({"lm_entry": lm_entry_phase(torch, np, mods, smi)}))
        phase("LM entry points", t0)
        return
    if args.train_ranks_only:
        import shutil
        t0 = time.perf_counter()
        lm_entry = lm_entry_phase(torch, np, mods, smi, parts="cd")
        phase("LM entry points (c) and (d)", t0)
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        print(json.dumps({"train_ranks": train_ranks_phase(
            np, shutil, lm_entry, smi, torch.cuda.device_count())}))
        phase("training over ranks", t0)
        return
    dry_dir = ROOT / "build" / "phase16"
    if args.dryrun_only:
        t0 = time.perf_counter()
        proc = dryrun_start(dry_dir)
        print(json.dumps({"dryrun": dryrun_phase(
            torch, np, None, None, args.n_series, smi, proc, dry_dir)}))
        phase("dry run", t0)
        return

    # ---- 2. build the kernels --------------------------------------------
    t0 = time.perf_counter()
    so, log = _build.build()
    _build.lib()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}")
    report = ptxas_report(log, "pairwise_l2.cu")
    smem = _build.lib().dumpy_pairwise_l2_smem_bytes()
    for line in report or ["library not rebuilt in this run: no report"]:
        print(f"  pairwise_l2 ptxas: {line}; dynamic shared memory {smem} "
              f"bytes a block")
    smem = [_build.lib().dumpy_lb_keogh_smem_bytes(p) for p in (0, 1, 2)]
    for line in (ptxas_report(log, "lb_keogh.cu")
                 or ["library not rebuilt in this run: no report"]):
        print(f"  lb_keogh ptxas: {line}; dynamic shared memory {smem[0]} "
              f"/ {smem[1]} (shared layout, 32- / 8-query tiles) / "
              f"{smem[2]} (per query) bytes a block")
    for src in ("lb_paa_interval.cu", "sax_encode.cu"):
        for line in (ptxas_report(log, src)
                     or ["library not rebuilt in this run: no report"]):
            print(f"  {src[:-3]} ptxas: {line}")
    print(f"  library {so.relative_to(ROOT)}")
    phase("build kernels", t0)
    params = DumpyParams(sax=SaxParams(w=16, b=8),
                         split=SplitParams(th=10_000))
    if args.skew_only:
        t0 = time.perf_counter()
        skew, _ = skew_fuzzy_phase(
            torch, np, search_device, search, ops, ref, mods, DumpyIndex,
            params, query_workload(N_QUERIES, LENGTH), args.n_series, None,
            launch_floor(torch, n_iter=50), smi)
        print(json.dumps({"skew_fuzzy": skew}))
        phase("skewed collection and Dumpy-Fuzzy", t0)
        return

    # ---- 3. data and index -------------------------------------------------
    t0 = time.perf_counter()
    db = random_walks(args.n_series, LENGTH, seed=args.seed)
    qs = query_workload(N_QUERIES, LENGTH)
    print(f"  data: {db.shape[0]} x {db.shape[1]} float32, {N_QUERIES} "
          f"held-out queries ({time.perf_counter() - t0:.3f} s)")
    t1 = time.perf_counter()
    index = DumpyIndex.build(db, params)
    host_build_s = time.perf_counter() - t1
    print(f"  host build: {index.flat.n_leaves} leaves, height "
          f"{index.stats.height} ({host_build_s:.3f} s)")
    t1 = time.perf_counter()
    dev = index.device_index(chunk=CHUNK, n_shards=1, device="cuda")
    torch.cuda.synchronize()
    W = dev.win_start.shape[1]
    print(f"  DeviceIndex: {W} spans of {dev.chunk}, "
          f"{dev.leaf_lo.shape[1]} leaf rows per shard incl. the pad leaf "
          f"({time.perf_counter() - t1:.3f} s)")
    phase("data and index", t0)

    # ---- 4. kernels against their twins ------------------------------------
    t0 = time.perf_counter()
    qs_all = torch.from_numpy(qs).cuda()
    qs_main = qs_all[:BATCH]
    floor = launch_floor(torch, n_iter=50)
    print(f"  launch floor (one-element add_, same timer): {floor:.5f} ms")
    rows = check_kernels(torch, ops, ref, breakpoints, query_prep,
                         resolve("dtw", LENGTH, BAND), qs_all, dev,
                         n_iter=50, floor=floor)
    clock_hz = sm_clock_hz()
    rows += check_dtw_kernels(torch, ops, ref, dtw_envelope_batch,
                              dtw2_masked_gather, qs_main, dev, n_iter=50,
                              clock_hz=clock_hz)
    phase("kernels vs twins", t0)

    # ---- 5. main path ------------------------------------------------------
    t0 = time.perf_counter()
    batches = [qs[i:i + BATCH] for i in range(0, N_QUERIES, BATCH)]
    exact_search_device_batch(index, batches[0], K, chunk=CHUNK)  # warm-up
    ed_kernels = ("sax_encode", "pairwise_l2", "lb_paa_interval")
    for m in mods.values():
        m.launches = 0
    torch.cuda.reset_peak_memory_stats()
    results, syncs = [], 0
    t1 = time.perf_counter()
    for qb in batches:
        ids, d, vis, st = exact_search_device_batch(
            index, qb, K, chunk=CHUNK, n_shards=1, return_stats=True)
        results.append((ids, d, vis))
        syncs += st["host_syncs"]
    elapsed = time.perf_counter() - t1
    launches = {name: m.launches for name, m in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    vis_all = np.concatenate([r[2] for r in results])
    print(f"  {N_QUERIES} queries in {len(batches)} batches of {BATCH}: "
          f"{elapsed:.3f} s, {N_QUERIES / elapsed:.2f} qps; mean spans "
          f"visited {vis_all.mean():.2f} / W={W}; host syncs {syncs}; "
          f"{elapsed * 1e3 / max(launches['pairwise_l2'], 1):.4f} ms per "
          f"span run")
    print(f"  launches on the main path: {launches}")
    print(f"  torch.cuda.max_memory_allocated: {peak} bytes")
    rand = {"ED": dict(qps=N_QUERIES / elapsed, peak_bytes=peak)}
    for name in ed_kernels:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the ED main path")

    t1 = time.perf_counter()
    tied = 0
    for qb, (ids, d, _) in zip(batches, results):
        bd, bi = brute_force(torch, dev,
                             torch.from_numpy(qb).cuda(), K)
        tied += check_exact(
            np, ids, d, bd.cpu().numpy(), bi.cpu().numpy(),
            lambda qi, i: np.sqrt(((db[i].astype(np.float64)
                                    - qb[qi].astype(np.float64)) ** 2).sum()),
            K)
    print(f"  all {N_QUERIES} exact top-{K} agree with the float64 brute "
          f"force (tied positions {tied}) ({time.perf_counter() - t1:.3f} s)")

    t1 = time.perf_counter()
    ids4, d4, _ = exact_search_device_batch(index, batches[0], K,
                                            chunk=CHUNK, n_shards=4)
    if not (np.array_equal(ids4, results[0][0])
            and np.array_equal(d4, results[0][1])):
        fail("n_shards=4 differs from n_shards=1")
    print(f"  n_shards=4 rerun of batch 0 is bitwise equal to n_shards=1 "
          f"({time.perf_counter() - t1:.3f} s)")
    phase("main path", t0)

    # ---- 6. where the time goes: one profiled batch ------------------------
    t0 = time.perf_counter()
    profile_batch(torch, exact_search_device_batch, index, batches[1],
                  host_ops=False)
    phase("profile", t0)

    # ---- 7. DTW main path ----------------------------------------------------
    t0 = time.perf_counter()
    builds = index._n_device_builds
    dtw_batches = [qs[i:i + BATCH] for i in range(0, N_DTW, BATCH)]
    for m in mods.values():
        m.launches = 0
    torch.cuda.reset_peak_memory_stats()
    dtw_results, stats = [], []
    t1 = time.perf_counter()
    for qb in dtw_batches:
        ids, d, vis, st = exact_search_device_batch(
            index, qb, K, chunk=CHUNK, metric="dtw", band=BAND,
            return_stats=True)
        dtw_results.append((ids, d, vis))
        stats.append(st)
    elapsed = time.perf_counter() - t1
    dtw_launches = {name: m.launches for name, m in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    total = {key: sum(st[key] for st in stats) for key in stats[0]}
    vis_all = np.concatenate([r[2] for r in dtw_results])
    print(f"  DTW (band {BAND}, order cluster): {N_DTW} queries in "
          f"{len(dtw_batches)} batches of {BATCH}: {elapsed:.3f} s, "
          f"{N_DTW / elapsed:.2f} qps; mean gather chunks visited "
          f"{vis_all.mean():.2f}")
    print(f"  cascade counters (both batches): {total}")
    print(f"  launches on the DTW path: {dtw_launches}")
    print(f"  torch.cuda.max_memory_allocated: {peak} bytes")
    rand["DTW"] = dict(qps=N_DTW / elapsed, peak_bytes=peak)
    for name in ("lb_keogh", "lb_improved", "dtw_band"):
        if dtw_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the DTW main path")

    t1 = time.perf_counter()
    tied, dp_rows = 0, 0
    for qb, (ids, d, _) in zip(dtw_batches[:1], dtw_results[:1]):
        bd, bi, n_rows = dtw_float64_check(
            torch, dev, torch.from_numpy(qb).cuda(), d, BAND, K)
        dp_rows += n_rows
        tied += check_exact(
            np, ids, d, bd.cpu().numpy(), bi.cpu().numpy(),
            lambda qi, i: dtw_np(qb[qi], db[i], BAND), K)
    print(f"  batch 0's {BATCH} DTW top-{K} agree with the independent "
          f"float64 check (tied positions {tied}; its DP ran on {dp_rows} "
          f"(query, row) pairs) ({time.perf_counter() - t1:.3f} s)")

    # each query's exact answer is its own, so a rerun of the batch's
    # first queries holds them against the whole batch's rows
    for label, kw, nq in (("order=perq", dict(order="perq"), BATCH),
                          ("order=shared", dict(order="shared"),
                           DTW_SHARED_QUERIES),
                          ("n_shards=4", dict(n_shards=4), BATCH)):
        t1 = time.perf_counter()
        ids_o, d_o, _ = exact_search_device_batch(
            index, dtw_batches[0][:nq], K, chunk=CHUNK, metric="dtw",
            band=BAND, **kw)
        if not (np.array_equal(ids_o, dtw_results[0][0][:nq])
                and np.array_equal(d_o, dtw_results[0][1][:nq])):
            fail(f"DTW {label} differs from order=cluster")
        print(f"  DTW {label} rerun of batch 0's first {nq} queries is "
              f"bitwise equal to order=cluster "
              f"({time.perf_counter() - t1:.3f} s)")
    if index._n_device_builds != builds:
        fail("the DTW phase built a second DeviceIndex layout")
    print(f"  no DeviceIndex built by the DTW phase (layouts cached: "
          f"{sorted(k[:2] for k in index._device_cache)})")
    t1 = time.perf_counter()
    calls = walk_calls(ops, search_device, index, dtw_batches[0])
    walk = check_walk_dtw(torch, ops, dtw2_masked_gather, calls, clock_hz,
                          n_sample=WALK_SAMPLE)
    next(r for r in rows if r["name"] == "dtw_band").update(walk)
    print(f"  ({time.perf_counter() - t1:.3f} s)")
    phase("DTW main path", t0)

    # ---- 8. DTW: one profiled batch --------------------------------------------
    t0 = time.perf_counter()
    profile_batch(torch, exact_search_device_batch, index, dtw_batches[1],
                  host_ops=False, metric="dtw", band=BAND)
    phase("DTW profile", t0)

    # ---- 9. approximate and extended search (paper Alg. 4) -------------------
    print(f"[phase] phases 1-8: {time.perf_counter() - t_run:.3f} s")
    t0 = time.perf_counter()
    paths, paths_b0 = search_paths_phase(
        torch, np, search_device, search, ops, ref, dtw2_masked_gather,
        dtw_np, index, dev, db, batches, dtw_batches, results, dtw_results,
        mods, floor, clock_hz, smi)
    print(json.dumps({"search_paths": paths}))
    phase("approximate and extended search", t0)

    # ---- 10. serving ---------------------------------------------------------
    t0 = time.perf_counter()
    serving = serving_phase(
        torch, np, search_device, search, ops, ref, dtw2_masked_gather,
        dtw_np, mods, CoalescingFrontend, ServingStats, KnnSoftmaxHead,
        index, dev, db, qs, batches, paths, floor, clock_hz, smi, args.seed)
    print(json.dumps({"serving": serving}))
    phase("serving", t0)

    # ---- 11. index lifecycle ---------------------------------------------------
    t0 = time.perf_counter()
    lifecycle = lifecycle_phase(
        torch, np, search_device, ops, mods, DumpyIndex, device_build,
        robustness_smoke, failpoints, breakpoints, random_walks, params,
        index, dev, db, batches, results, host_build_s, args.seed)
    print(json.dumps({"lifecycle": lifecycle}))
    phase("index lifecycle", t0)

    # ---- 12. distributed and baselines -----------------------------------------
    t0 = time.perf_counter()
    for key in [k for k in index._device_cache if k[:2] != (CHUNK, 1)]:
        del index._device_cache[key]       # phase 5's four-shard layout
    torch.cuda.empty_cache()
    distributed, new_shapes = distributed_phase(
        torch, np, search_device, ops, ref, mods, dist, sharding, breakpoints,
        params, index, dev, db, batches, dtw_batches, results, dtw_results,
        paths_b0, lifecycle, floor, smi)
    print(json.dumps({"distributed": distributed}))
    base, new_shapes["lb_paa_interval"] = baselines_phase(
        torch, np, search_device, ops, ref, mods, (isax2plus, tardis),
        DumpyIndex, params, db, batches, floor, smi)
    print(json.dumps({"baselines": base}))
    phase("distributed and baselines", t0)

    # ---- 13. the analysis gates ------------------------------------------------
    t0 = time.perf_counter()
    analysis = analysis_phase(
        torch, np, search_device, mods, index, dev, batches, dtw_batches,
        results, dtw_results, paths_b0, smi)
    print(json.dumps({"analysis": analysis}))
    phase("analysis gates", t0)

    # ---- 16 (b), the exact cells: here, while the layout is resident --------
    t0 = time.perf_counter()
    dry_exact = dryrun_exact(torch, search_device, index, dev, batches,
                             dtw_batches, analysis["main_path"],
                             args.n_series, smi)
    phase("dry run (b): exact cells", t0)

    # ---- 18. the skewed collection and Dumpy-Fuzzy --------------------------
    t0 = time.perf_counter()
    print(f"  torch.cuda.memory_allocated before: "
          f"{torch.cuda.memory_allocated()} bytes")
    skew, skew_shapes = skew_fuzzy_phase(
        torch, np, search_device, search, ops, ref, mods, DumpyIndex, params,
        qs, args.n_series, rand, floor, smi)
    new_shapes["lb_paa_interval"] += skew_shapes["lb_paa_interval"]
    print(json.dumps({"skew_fuzzy": skew}))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  torch.cuda.memory_allocated after: "
          f"{torch.cuda.memory_allocated()} bytes (its layouts freed)")
    phase("skewed collection and Dumpy-Fuzzy", t0)
    if args.search_only:
        return

    # ---- 14. the LM substrate ---------------------------------------------------
    # phase 16's production cells count on the host in a child process from
    # here on, beside phases 14 and 15
    proc = dryrun_start(dry_dir)
    t0 = time.perf_counter()
    del index, dev
    torch.cuda.empty_cache()
    print(json.dumps({"lm": lm_phase(torch, np, args.seed, smi)}))
    phase("LM substrate", t0)

    # ---- 15. the LM entry points -------------------------------------------------
    t0 = time.perf_counter()
    lm_entry = lm_entry_phase(torch, np, mods, smi)
    print(json.dumps({"lm_entry": lm_entry}))
    phase("LM entry points", t0)

    # ---- 16. the dry run (its child counting since phase 14) ----------------------
    t0 = time.perf_counter()
    print(json.dumps({"dryrun": dryrun_phase(
        torch, np, rows, distributed, args.n_series, smi, proc, dry_dir,
        dry_exact)}))
    phase("dry run", t0)

    # ---- 17. training over ranks -------------------------------------------------
    import shutil
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    print(json.dumps({"train_ranks": train_ranks_phase(
        np, shutil, lm_entry, smi, torch.cuda.device_count())}))
    phase("training over ranks", t0)
    print(f"[phase] whole run: {time.perf_counter() - t_run:.3f} s")

    for r in rows:
        r["launches"] = (launches if r["name"] in ed_kernels
                         else dtw_launches)[r["name"]]
        r["floor_ms"] = floor
        r["new_shapes"] = new_shapes.get(r["name"], [])
        r["skew_fuzzy_launches"] = skew["launches"][r["name"]]
        # phase 15 (b): launches a decode step of OLMo-1B with the head
        r["lm_decode_launches_per_step"] = \
            lm_entry["b"]["head"]["launches_per_step"][r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "floor_ms", "new_shapes", "lm_decode_launches_per_step",
            "skew_fuzzy_launches")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["train-rank"]:
        train_rank_child(sys.argv[2:])
    else:
        main()
