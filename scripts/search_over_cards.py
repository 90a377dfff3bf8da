#!/usr/bin/env python3
"""The sharded Dumpy index on every card of one machine, held bitwise to
one card.

    python3 scripts/search_over_cards.py            # a machine with 4 GPUs
    PYTHONPATH=src python3 scripts/search_over_cards.py --device cpu \\
        --n-series 3000                              # a rehearsal here

The collection is the paper's *Rand* (``random_walks`` from ``--seed``,
made here, nothing read), 256 points a series, indexed with w 16, b 8 and
th 10 000 by the device build (``backend="device"``), chunk 2048; queries
are ``query_workload``'s held-out walks, a batch of 64, k 10, DTW band 25.
Three meshes hold the index: one card (``[cuda:0]``, one shard), four
shards on one card (``[cuda:0] x 4``) and four shards on four cards
(``[cuda:0..3]``).  On each mesh, through the entry points:

(a) ``--n-series`` (4 M) series: ``encode_distributed`` (each shard's SAX
    table and the summed histogram bitwise the one-card run, the histogram
    summing to N) and ``build_distributed`` on the four cards (its table
    bitwise); exact ED, exact DTW in the ``cluster`` and ``perq`` orders
    (ids, distances, visited counts and cascade counters), extended ED
    nbr 4 with the re-rank, extended DTW nbr 4, approximate ED nbr 4 and a
    64-lane serving bucket (25% DTW, a dead lane), each bitwise the
    one-card answer (the counters bitwise ``[cuda:0] x 4``'s); exact ED
    with the last shard dead: its coverage equals ``shard_coverage`` and
    its answers a float64 top-k over the live rows; the bucket's launch
    returning under ``torch.cuda.set_sync_debug_mode("error")``; then the
    six kernels on every card at the search's shapes, each bitwise its run
    on ``cuda:0`` and within its tolerance of its plain version, timed.
(b) ``--big`` (16 M) series, about phase (a)'s collection on each card of
    four: exact ED and DTW ``cluster``, one batch each, on the four cards
    bitwise the same index on ``cuda:0`` alone; the exact ED answers held
    to a float64 brute force over every row.  Cut to half while the host
    lacks memory for it (the cut is printed).

For each path and mesh it prints the batch's wall ms, each card's busy ms
(the union of its kernel and copy intervals in one more run under the
profiler's CUDA activity), the overlap (the cards' busy ms summed over the
wall), the host reads of the exact loops and the kernel launches per card,
the bytes and ms of the device-to-device moves (the queries out to the
shards, the shards' lists back for the merge), and the placement's set-up
seconds; a JSON of it all goes to ``--out``.  No time is a gate.  It exits
non-zero if any check fails.  The cards' names and power limits are
printed first and last (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
K, CHUNK, BAND, LENGTH, BATCH, NBR = 10, 2048, 25, 256, 64, 4
KERNELS = ("sax_encode", "pairwise_l2", "lb_paa_interval", "lb_keogh",
           "lb_improved", "dtw_band")


def fail(msg: str) -> None:
    print(f"search_over_cards: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()


def same(np, got, want, what: str) -> None:
    if len(got) != len(want) or not all(
            np.array_equal(a, b) for a, b in zip(got, want)):
        fail(f"{what} differs from the one-card answer")


class Meter:
    """What a call does per card: the exact loops' host reads
    (``search_device._drive``, shard ``s`` on ``mesh.devices[s]``), the
    kernel launches (``ops``' kernels, by their first tensor's device) and
    the device-to-device moves (``search_device._to_device``: bytes, and ms
    between CUDA events on the source card's stream, where the copy
    runs)."""

    def __init__(self, torch, sd, ops):
        self.torch, self.sd, self.ops = torch, sd, ops
        self.mesh = None
        self.reset()
        real_drive, real_move = sd._drive, sd._to_device

        def drive(loops, *a):
            results, reads = real_drive(loops, *a)
            for s, r in enumerate(reads):
                dev = (str(self.mesh.devices[s]) if self.mesh is not None
                       and len(reads) == self.mesh.size else "home")
                self.reads[dev] = self.reads.get(dev, 0) + r
            return results, reads

        def move(tree, device):
            if not isinstance(tree, torch.Tensor) or tree.device == \
                    torch.device(device):
                return real_move(tree, device)
            src, dst = tree.device, torch.device(device)
            ev = None
            if src.type == "cuda":
                with torch.cuda.device(src):
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                    out = real_move(tree, device)
                    ev[1].record()
            else:
                out = real_move(tree, device)
            self.moves.append((str(src), str(dst),
                               tree.numel() * tree.element_size(), ev))
            return out

        sd._drive, sd._to_device = drive, move
        for name in KERNELS:
            real = getattr(ops, name)

            def counted(*a, _real=real, _name=name, **kw):
                t = next(x for x in a if isinstance(x, torch.Tensor))
                if t.is_cuda:
                    key = (_name, str(t.device))
                    self.launches[key] = self.launches.get(key, 0) + 1
                return _real(*a, **kw)

            setattr(ops, name, counted)

    def reset(self, mesh=None):
        self.mesh = mesh
        self.reads, self.launches, self.moves = {}, {}, []

    def report(self) -> dict:
        moves = {}
        for src, dst, nbytes, ev in self.moves:
            row = moves.setdefault(f"{src}->{dst}", [0, 0, 0.0])
            row[0] += 1
            row[1] += nbytes
            if ev is not None:
                row[2] += ev[0].elapsed_time(ev[1])
        per_card = {}
        for (name, dev), n in sorted(self.launches.items()):
            per_card.setdefault(dev, {})[name] = n
        return {"host_reads": dict(sorted(self.reads.items())),
                "launches": per_card,
                "moves": {k: {"count": c, "bytes": b, "ms": ms}
                          for k, (c, b, ms) in sorted(moves.items())}}


def busy_ms(torch, fn) -> tuple[object, dict | None]:
    """``fn()`` under the profiler's CUDA activity → ``(its result, {card:
    busy ms})``: the union of each card's kernel, copy and set intervals,
    read from the profiler's raw events (its table form takes tens of
    seconds to build for a DTW batch)."""
    from torch.autograd.profiler import (ProfilerConfig, ProfilerState,
                                         _disable_profiler, _enable_profiler,
                                         _prepare_profiler)
    from torch.profiler import ProfilerActivity
    from torch._C._profiler import _ExperimentalConfig
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    acts = {ProfilerActivity.CUDA}
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    try:
        out = fn()
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
    finally:
        res = _disable_profiler()
    spans: dict = {}
    for e in res.events():
        if e.device_type() == torch._C._autograd.DeviceType.CUDA \
                and e.duration_ns() > 0:
            spans.setdefault(e.device_index(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    busy = {}
    for d, iv in spans.items():
        iv.sort()
        total, (a, b) = 0, iv[0]
        for s, e in iv[1:]:
            if s > b:
                total += b - a
                a, b = s, e
            else:
                b = max(b, e)
        busy[f"cuda:{d}"] = (total + b - a) / 1e6
    return out, busy


def sync_mesh(torch, mesh) -> None:
    for card in mesh.distinct:
        if card.type == "cuda":
            torch.cuda.synchronize(card)


def free_cards(torch, mesh) -> None:
    """Release the cached blocks of every card of ``mesh``."""
    for card in mesh.distinct:
        if card.type == "cuda":
            with torch.cuda.device(card):
                torch.cuda.empty_cache()


def run_path(torch, meter, mesh, fn, cuda: bool) -> tuple:
    """``fn()`` once, timed and metered, then (on the card) once more under
    the profiler → ``(result, record)``."""
    meter.reset(mesh)
    sync_mesh(torch, mesh)
    t0 = time.perf_counter()
    res = fn()
    sync_mesh(torch, mesh)
    wall = (time.perf_counter() - t0) * 1e3
    rec = {"wall_ms": wall, **meter.report()}
    if cuda:
        _, busy = busy_ms(torch, fn)
        rec["busy_ms"] = busy
        rec["overlap"] = sum(busy.values()) / wall
    else:
        rec["busy_ms"] = "not measured (cpu)"
    return res, rec


def show(label: str, rec: dict) -> None:
    busy = rec["busy_ms"]
    b = ({k: round(v, 3) for k, v in busy.items()}
         if isinstance(busy, dict) else busy)
    ov = f", overlap {rec['overlap']:.3f}" if "overlap" in rec else ""
    print(f"    {label}: wall {rec['wall_ms']:.3f} ms, busy {b}{ov}; "
          f"reads {rec['host_reads']}; launches {rec['launches']}; moves "
          f"{rec['moves']}", flush=True)


def kernels_on_cards(torch, np, ops, ref, mods, smoke, prep, qs, dev, cards,
                     cuda: bool) -> dict:
    """The six kernels on every card at the search's shapes: each output
    bitwise the same call on the first card, within its tolerance of its
    plain version (``sax_encode`` and ``lb_paa_interval`` bitwise their
    in-order sums, ``dtw_band`` bitwise its twin, ``pairwise_l2`` within
    1e-5·(|q|² + |x|²), the LB kernels within rtol 1e-5), and timed (CUDA
    events on a held stream, ``chip_smoke.time_ms``)."""
    seg_lo, seg_hi, env_lo, env_hi = prep
    x = dev.db[0][:CHUNK].contiguous()
    lo, hi = dev.leaf_lo_g, dev.leaf_hi_g
    g = torch.Generator(device="cpu").manual_seed(0)
    Qg = min(16, qs.shape[0])
    rows_x = dev.db[0][:1 << 16]         # the walk's rows, gathered by idx
    idx = torch.randint(0, rows_x.shape[0], (Qg, 128), generator=g)
    mask = torch.rand((Qg, 128), generator=g) < 0.9
    inf = torch.full((Qg,), float("inf"))
    calls = {
        "sax_encode": (lambda a: ops.sax_encode(a[0], 16, 8),
                       lambda a: ref.sax_encode_in_order(a[0], 16, 8),
                       "bitwise", (qs,)),
        "pairwise_l2": (lambda a: ops.pairwise_l2(*a),
                        lambda a: ref.pairwise_l2_ref(*a), "l2", (qs, x)),
        "lb_paa_interval": (
            lambda a: ops.lb_paa_interval(*a, LENGTH),
            lambda a: ref.lb_paa_interval_in_order(*a, LENGTH), "bitwise",
            (seg_lo, seg_hi, lo, hi)),
        "lb_keogh": (lambda a: ops.lb_keogh(*a),
                     lambda a: ref.lb_keogh_ref(*a), "rtol",
                     (x, env_hi, env_lo)),
        "lb_improved": (lambda a: ops.lb_improved(*a, BAND),
                        lambda a: ref.lb_improved_ref(*a, BAND), "rtol",
                        (x, qs, env_hi, env_lo)),
        "dtw_band": (lambda a: ops.dtw_band(a[0], a[1], a[2], a[3], BAND,
                                            idx=a[4]),
                     lambda a: ref.dtw_band_ref(a[0], a[1], a[2], a[3], BAND,
                                                idx=a[4]),
                     "bitwise", (qs[:Qg], rows_x, mask, inf, idx)),
    }
    out = {}
    for name, (kern, plain, tol, args) in calls.items():
        first, rows = None, {}
        for card in cards:
            a = tuple(t.to(card).contiguous() for t in args)
            before = mods[name].launches
            got = kern(a)
            if cuda and mods[name].launches != before + 1:
                fail(f"{name} did not launch on {card}")
            got_t = got if isinstance(got, tuple) else (got,)
            # on the CPU the wrapper runs the plain version itself
            want = plain(a) if cuda else got
            want_t = want if isinstance(want, tuple) else (want,)
            err = 0.0
            for gv, wv in zip(got_t, want_t):
                gf, wf = gv.double(), wv.double()
                fin = torch.isfinite(wf)
                if not torch.equal(torch.isfinite(gf), fin):
                    fail(f"{name} on {card}: +inf lanes differ from its "
                         f"plain version")
                err = max(err, float((gf - wf)[fin].abs().max())
                          if bool(fin.any()) else 0.0)
                if tol == "bitwise" and not torch.equal(gv.to(wv.dtype), wv):
                    fail(f"{name} on {card} is not bitwise its plain "
                         f"version")
            if tol == "l2":
                q, xx = a
                scale = (q * q).sum(1)[:, None] + (xx * xx).sum(1)[None, :]
                if not bool(((got - want).abs() <= 1e-5 * scale).all()):
                    fail(f"pairwise_l2 on {card} beyond 1e-5 of its twin")
            if tol == "rtol":
                fin = torch.isfinite(want)
                if not bool(((got - want).abs()
                             <= 1e-5 * want.abs() + 1e-6)[fin].all()):
                    fail(f"{name} on {card} beyond rtol 1e-5 of its twin")
            host = tuple(t.cpu() for t in got_t)
            if first is None:
                first = host
            elif not all(torch.equal(u, v) for u, v in zip(host, first)):
                fail(f"{name} on {card} is not bitwise its run on "
                     f"{cards[0]}")
            ms = None
            if cuda:
                with torch.cuda.device(card):
                    ms, _ = smoke.time_ms(torch, lambda *aa: kern(aa),
                                          [a] * 20, warmup=2)
            rows[str(card)] = {"ms": ms, "max_abs_err": err}
        out[name] = rows
        print(f"    {name}: " + ", ".join(
            f"{c} {r['ms']:.5f} ms" if r["ms"] is not None else f"{c} ran"
            for c, r in rows.items()) + f"; max |err| vs plain "
            f"{max(r['max_abs_err'] for r in rows.values()):.3e}; bitwise "
            f"across the cards", flush=True)
    return out


def degraded_check(torch, np, smoke, sd, index, dev1, mesh, qb, got) -> dict:
    """Exact ED with the mesh's last shard dead: coverage equal to
    ``shard_coverage``, answers a float64 top-k over the live rows."""
    ids, d, cov = got
    devm = index.device_index(chunk=CHUNK, mesh=mesh)
    health = (True,) * (mesh.size - 1) + (False,)
    want = sd.shard_coverage(index, devm.with_shard_health(health))
    if cov != want or not 0.0 < cov < 1.0:
        fail(f"degraded coverage {cov} != shard_coverage {want}")
    # the live rows: ordered positions below the last shard's first row
    live = torch.zeros(dev1.db[0].shape[0], dtype=torch.bool,
                       device=dev1.device)
    live[:devm.row_bounds[-2]] = True
    q32 = torch.from_numpy(qb).to(dev1.device)
    bd, bi = smoke.brute_force(torch, dev1, q32, K, live=live)
    db = index.db
    tied = smoke.check_exact(
        np, ids, d, bd.cpu().numpy(), bi.cpu().numpy(),
        lambda qi, i: np.sqrt(((db[i].astype(np.float64)
                                - qb[qi].astype(np.float64)) ** 2).sum()), K)
    return {"coverage": cov, "tied": tied}


def placed(torch, index, mesh, cuda: bool) -> tuple:
    """``index.device_index`` on ``mesh``, timed by the caller → ``(the
    placed index, {card: peak bytes it added})``.  On a mesh of several
    cards the layout is made on the host and each shard sent to its card:
    fails if the first card's peak grew by half the collection or more
    (it must never hold the whole collection)."""
    sync_mesh(torch, mesh)
    base = {}
    if cuda:
        for d in mesh.distinct:
            torch.cuda.reset_peak_memory_stats(d)
            base[d] = torch.cuda.memory_allocated(d)
    devm = index.device_index(chunk=CHUNK, mesh=mesh)
    sync_mesh(torch, mesh)
    grew = {str(d): torch.cuda.max_memory_allocated(d) - b
            for d, b in base.items()}
    whole = index.db.nbytes
    if len(mesh.distinct) > 1 and grew[str(mesh.devices[0])] >= whole // 2:
        fail(f"placing on {list(map(str, mesh.distinct))} added "
             f"{grew[str(mesh.devices[0])]} B on the first card, against a "
             f"{whole} B collection")
    return devm, grew


def collection(np, random_walks, n: int, seed: int, block: int):
    """``n`` random walks: ``random_walks(block, ...)`` blocks seeded
    ``seed``, ``seed + 1``, ... (the first block is phase (a)'s
    collection)."""
    parts = [random_walks(min(block, n - s0), LENGTH, seed=seed + i)
             for i, s0 in enumerate(range(0, n, block))]
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def host_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-series", type=int, default=4_000_000)
    ap.add_argument("--big", type=int, default=None,
                    help="(b)'s collection (default 4 x --n-series; 0 "
                         "skips it)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "search_over_cards.json"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as smoke
    from repro_torch.core import distributed as dist
    from repro_torch.core import search_device as sd
    from repro_torch.core.build import DumpyParams
    from repro_torch.core.index import DumpyIndex
    from repro_torch.core.metric import resolve
    from repro_torch.core.sax import SaxParams
    from repro_torch.core.split import SplitParams
    from repro_torch.data.series import query_workload, random_walks
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.kernels import (_build, dtw_band, lb_improved, lb_isax,
                                     lb_keogh, ops, pairwise_l2, ref,
                                     sax_encode)
    smoke.fail = fail
    cuda = args.device == "cuda"
    t_all = time.perf_counter()
    report: dict = {}
    if cuda:
        if not torch.cuda.is_available():
            fail("no CUDA device (run with --device cpu to rehearse)")
        cards_txt = smi()
        print("cards:", cards_txt, flush=True)
        report["cards"] = cards_txt
        n_cards = torch.cuda.device_count()
        if n_cards < 2:
            fail(f"{n_cards} card(s): this run needs two or more")
        t0 = time.perf_counter()
        so, _ = _build.build()
        _build.lib()
        print(f"kernels built: {so.name} ({time.perf_counter() - t0:.3f} s)")
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        meshes = {"one card": make_mesh(["cuda:0"]),
                  "[cuda:0] x 4": make_mesh(["cuda:0"] * 4),
                  "cards": make_mesh([f"cuda:{s % n_cards}"
                                      for s in range(4)])}
    else:
        cards = [torch.device("cpu")]
        meshes = {"one card": make_mesh(["cpu"]),
                  "[cuda:0] x 4": make_mesh(["cpu"] * 4),
                  "cards": make_mesh(["cpu"] * 4)}
    home = meshes["one card"].devices[0]
    mods = {"sax_encode": sax_encode, "pairwise_l2": pairwise_l2,
            "lb_paa_interval": lb_isax, "lb_keogh": lb_keogh,
            "lb_improved": lb_improved, "dtw_band": dtw_band}
    meter = Meter(torch, sd, ops)
    th = min(10_000, max(args.n_series // 50, 16))
    params = DumpyParams(sax=SaxParams(w=16, b=8), split=SplitParams(th=th))
    qs = query_workload(256, LENGTH)
    qb = qs[:args.batch]
    dtw = dict(metric="dtw", band=BAND)

    # ---- (a) phase 12's collection --------------------------------------------
    t0 = time.perf_counter()
    N = args.n_series
    db = collection(np, random_walks, N, args.seed, N)
    t1 = time.perf_counter()
    index = DumpyIndex.build(db, params, backend="device", device=home)
    build_s = time.perf_counter() - t1
    print(f"(a) {N} x {LENGTH}, th {th}: data "
          f"{t1 - t0:.3f} s, device build {build_s:.3f} s, "
          f"{index.flat.n_leaves} leaves, height {index.stats.height}",
          flush=True)
    rec_a: dict = {"n_series": N, "th": th, "leaves": index.flat.n_leaves,
                   "build_s": build_s, "encode": {}, "placement_s": {},
                   "paths": {}}

    # encode_distributed on each mesh, build_distributed on the cards
    enc = {}
    for label, mesh in meshes.items():
        meter.reset(mesh)
        sync_mesh(torch, mesh)
        t1 = time.perf_counter()
        paa, sax, hist = dist.encode_distributed(db, 16, 8, mesh=mesh)
        sync_mesh(torch, mesh)
        enc[label] = (paa, sax, hist.cpu().numpy())
        rec_a["encode"][label] = {"s": time.perf_counter() - t1,
                                  **meter.report()}
        if int(enc[label][2].sum()) != N:
            fail(f"the histogram on {label} sums to "
                 f"{int(enc[label][2].sum())}, not {N}")
        same(np, enc[label], enc["one card"], f"encode_distributed on "
             f"{label}")
    t1 = time.perf_counter()
    idx_c = dist.build_distributed(db, params, mesh=meshes["cards"])
    rec_a["build_distributed_s"] = time.perf_counter() - t1
    same(np, (idx_c.paa, idx_c.sax), enc["one card"][:2],
         "build_distributed's table on the cards")
    print(f"  encode_distributed: tables and histograms bitwise one card's"
          f" on every mesh, histogram summing to {N}; seconds "
          f"{ {k: round(v['s'], 3) for k, v in rec_a['encode'].items()} }; "
          f"build_distributed on the cards {rec_a['build_distributed_s']:.3f}"
          f" s, {idx_c.flat.n_leaves} leaves, table bitwise", flush=True)
    del idx_c, enc

    ks, nbrs, mets = smoke.serving_knobs(args.batch, 0)

    def bucket(m, q):
        """The serving bucket of ``len(q)`` lanes (25% DTW, lane 1 dead)."""
        kq, nq, mq = smoke.serving_knobs(len(q), 0)
        q = q.copy()
        q[[i for i, k in enumerate(kq) if k == 0]] = 0.0    # dead lanes
        return sd.bucket_search_device_batch(index, q, kq, nq, mq,
                                             band=BAND, chunk=CHUNK, mesh=m)

    # each path on a mesh ``m`` and a query batch ``q``
    paths = {
        "exact ED": lambda m, q: sd.exact_search_device_batch(
            index, q, K, chunk=CHUNK, mesh=m, return_stats=True),
        "exact DTW cluster": lambda m, q: sd.exact_search_device_batch(
            index, q, K, chunk=CHUNK, mesh=m, order="cluster",
            return_stats=True, **dtw),
        "exact DTW perq": lambda m, q: sd.exact_search_device_batch(
            index, q, K, chunk=CHUNK, mesh=m, order="perq",
            return_stats=True, **dtw),
        "extended ED nbr 4 rerank": lambda m, q: dist.search_distributed(
            index, q, K, nbr=NBR, mesh=m),
        "extended DTW nbr 4": lambda m, q: dist.search_distributed(
            index, q, K, nbr=NBR, mesh=m, **dtw),
        "approximate ED nbr 4": lambda m, q:
            sd.approximate_search_device_batch(
                index, q, K, nbr=NBR,
                dev=index.device_index(chunk=CHUNK, mesh=m)),
        "bucket 64 lanes": bucket,
        "degraded exact ED": lambda m, q: dist.search_distributed(
            index, q, K, mesh=m,
            shard_health=(True,) * (m.size - 1) + (False,)),
    }
    qbk = qb.copy()
    qbk[[i for i, k in enumerate(ks) if k == 0]] = 0.0     # dead lanes
    answers: dict = {}
    dev1 = None
    for label, mesh in meshes.items():
        print(f"  mesh {label} {[str(d) for d in mesh.devices]}:",
              flush=True)
        t1 = time.perf_counter()
        devm, grew = placed(torch, index, mesh, cuda)
        rec_a["placement_s"][label] = time.perf_counter() - t1
        rec_a.setdefault("placement_peak_bytes", {})[label] = grew
        if label == "one card":
            dev1 = devm
        print(f"    placement {rec_a['placement_s'][label]:.3f} s, shards "
              f"on {[str(t.device) for t in devm.db]}, peak bytes added "
              f"per card {grew}", flush=True)
        rows = rec_a["paths"].setdefault(label, {})
        for name, fn in paths.items():
            if name == "degraded exact ED" and mesh.size == 1:
                continue
            fn(mesh, qs[-4:])              # warm: first launches per card
            res, rec = run_path(torch, meter, mesh, lambda: fn(mesh, qb),
                                cuda)
            if name.startswith("exact"):
                got = res[:3] + (tuple(v for kk, v in res[3].items()
                                       if kk != "host_syncs"),)
                rec["host_syncs"] = res[3]["host_syncs"]
                want = answers.get((name, "one card"))
                if want is not None:
                    same(np, got[:2], want[:2], f"{name} on {label}")
                if label == "cards":
                    same(np, got, answers[(name, "[cuda:0] x 4")],
                         f"{name}'s visited counts and counters on {label}")
                    if rec["host_syncs"] != answers[(name, "syncs x 4")]:
                        fail(f"{name}: {rec['host_syncs']} host syncs on "
                             f"the cards, "
                             f"{answers[(name, 'syncs x 4')]} on one")
                answers[(name, "syncs " + ("x 4" if label == "[cuda:0] x 4"
                                           else label))] = rec["host_syncs"]
                answers[(name, label)] = got
            elif name == "degraded exact ED":
                rec.update(degraded_check(torch, np, smoke, sd, index, dev1,
                                          mesh, qb, res))
                if label == "cards":
                    same(np, res, answers[(name, "[cuda:0] x 4")],
                         f"{name} on {label}")
                answers[(name, label)] = res
            else:
                if label != "one card":
                    same(np, res, answers[(name, "one card")],
                         f"{name} on {label}")
                answers[(name, label)] = res
            rows[name] = rec
            show(name, rec)
        if label == "cards":
            # the bucket's launch queues without a host wait on the cards
            lane_nbr = np.where(np.asarray(ks) > 0, np.asarray(nbrs), 0)
            lane_dtw = (np.asarray(mets) == "dtw") & (np.asarray(ks) > 0)
            qd = torch.from_numpy(qbk).to(home)
            if cuda:
                torch.cuda.synchronize(home)
                torch.cuda.set_sync_debug_mode("error")
            try:
                res = sd.bucket_search_launch(
                    index, qd, lane_nbr, lane_dtw, k_max=max(ks),
                    nbr_max=max(nbrs), band=BAND, dev=devm)
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(0)
            got = sd.bucket_search_finish(
                res, np.asarray(ks), lane_nbr, k_max=max(ks))
            same(np, got, answers[("bucket 64 lanes", "one card")],
                 "the bucket launched under sync debug mode 'error'")
            print("    bucket_search_launch returned under "
                  "set_sync_debug_mode('error'); its answer bitwise",
                  flush=True)
            rec_a["bucket_launch_without_sync"] = True
        del devm
        for key in [k for k in index._device_cache
                    if k[3] is mesh and label != "one card"]:
            del index._device_cache[key]
        free_cards(torch, mesh)

    # the six kernels on every card
    print("  kernels on every card:", flush=True)
    met = resolve("dtw", LENGTH, BAND)
    q32 = torch.from_numpy(qb).to(home)
    prep, _ = sd._prep_batch(met, q32, 16, 8)
    rec_a["kernels"] = kernels_on_cards(torch, np, ops, ref, mods, smoke,
                                        prep, q32, dev1, cards, cuda)
    report["a"] = rec_a
    del dev1
    index = db = None
    free_cards(torch, meshes["cards"])

    # ---- (b) a collection each card of four holds at (a)'s size -----------------
    big = 4 * N if args.big is None else args.big
    if big:
        need = 4 * big * LENGTH * 4     # the rows, their host layout, copies
        if host_bytes() < need:
            print(f"(b) the host has {host_bytes() / 2**30:.1f} GiB "
                  f"available, {need / 2**30:.1f} GiB needed for {big}: cut "
                  f"to {big // 2}", flush=True)
            big //= 2
        t0 = time.perf_counter()
        db = collection(np, random_walks, big, args.seed, N)
        t1 = time.perf_counter()
        index = DumpyIndex.build(db, params, backend="device", device=home)
        build_s = time.perf_counter() - t1
        print(f"(b) {big} x {LENGTH}: data {t1 - t0:.3f} s, device build "
              f"{build_s:.3f} s, {index.flat.n_leaves} leaves", flush=True)
        rec_b: dict = {"n_series": big, "build_s": build_s,
                       "leaves": index.flat.n_leaves, "placement_s": {},
                       "paths": {}}
        got_b: dict = {}
        for label in ("one card", "cards"):
            mesh = meshes[label]
            t1 = time.perf_counter()
            devm, grew = placed(torch, index, mesh, cuda)
            rec_b["placement_s"][label] = time.perf_counter() - t1
            rec_b.setdefault("placement_peak_bytes", {})[label] = grew
            print(f"  mesh {label}: placement "
                  f"{rec_b['placement_s'][label]:.3f} s, peak bytes added "
                  f"per card {grew}", flush=True)
            rows = rec_b["paths"].setdefault(label, {})
            for name in ("exact ED", "exact DTW cluster"):
                paths[name](mesh, qs[-4:])                      # warm
                res, rec = run_path(torch, meter, mesh,
                                    lambda: paths[name](mesh, qb), cuda)
                res = res[:3] + (tuple(v for kk, v in res[3].items()
                                       if kk != "host_syncs"),)
                if label == "cards":
                    same(np, res[:2], got_b[name][:2], f"(b) {name} on the "
                         f"cards")
                got_b[name] = res
                rows[name] = rec
                show(name, rec)
            if label == "one card":
                q32 = torch.from_numpy(qb).to(home)
                bd, bi = smoke.brute_force(torch, devm, q32, K)
                ids, d = got_b["exact ED"][:2]
                rec_b["float64_tied"] = smoke.check_exact(
                    np, ids, d, bd.cpu().numpy(), bi.cpu().numpy(),
                    lambda qi, i: np.sqrt(((db[i].astype(np.float64)
                                            - qb[qi].astype(np.float64))
                                           ** 2).sum()), K)
                print(f"  exact ED held to the float64 brute force over "
                      f"{big} rows (tied {rec_b['float64_tied']})",
                      flush=True)
                del bd, bi
            del devm
            for key in [k for k in index._device_cache if k[3] is mesh]:
                del index._device_cache[key]
            free_cards(torch, mesh)
        report["b"] = rec_b

    report["seconds"] = time.perf_counter() - t_all
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1, default=str))
    print(f"every check passed in {report['seconds']:.3f} s; the record in "
          f"{args.out}", flush=True)
    if cuda:
        print("cards:", smi(), flush=True)


if __name__ == "__main__":
    main()
