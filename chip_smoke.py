#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # the full run: 4 M x 256 series
    python3 chip_smoke.py --n-series 200000   # a shorter rehearsal

Phases, each printed with its seconds:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build: the three CUDA kernels compile from ``src/repro_torch/kernels/csrc``
   into ``build/kernels/`` (one ``nvcc`` per source, in parallel);
3. data and index: the paper's *Rand* collection (``random_walks``), the
   host build with the paper's defaults (w=16, b=8, th=10 000), the upload
   of the leaf-aligned ``DeviceIndex`` (chunk 2048, one shard);
4. kernels: ``sax_encode``, ``pairwise_l2`` and ``lb_paa_interval`` each
   against its plain PyTorch twin on the card, at the main path's shapes
   (taken from this index and these queries) and at ragged ones, with the
   stated tolerances; each kernel's time next to its bound, its twin's time
   and, where one PyTorch call computes the same function, that call's time;
5. main path: 256 held-out queries in 4 batches of 64 through
   ``exact_search_device_batch`` (k=10), every result held against a
   float64 brute force on the card, one batch rerun with ``n_shards=4``
   (bitwise equal), and the launch count of each kernel on this phase;
6. profile: one more batch under ``torch.profiler`` (device time by kernel,
   the device's busy share of the batch).

Any mismatch exits non-zero; so does a machine without CUDA, and a
directory without the ``src/repro_torch`` package.  The line before the last
is the card's name and power limit; the last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
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


def check_kernels(torch, np, ops, ref, breakpoints, qs_main, dev, n_iter):
    """Phase 4: every kernel against its twin; returns the kernel table
    rows without ``launches``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []

    # -- sax_encode: PAA within 1e-6; symbols equal away from breakpoints --
    err, differ = 0.0, 0
    cases = [(qs_main, 16, 8),
             (qs_main[:1].contiguous(), 16, 8),
             (torch.randn(300, 96, generator=gen, device="cuda"), 12, 8)]
    for x, w, b in cases:
        paa, sax = ops.sax_encode(x, w, b)
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
        print(f"  sax_encode {tuple(x.shape)} w={w} b={b}: paa max |err| "
              f"{float((paa - paa_r).abs().max()):.3e}, symbols differing "
              f"{int((sax != sax_r).sum())}")
    B, n = qs_main.shape
    xs = [(qs_main, 16, 8)] * n_iter
    ms, host = time_ms(torch, ops.sax_encode, xs)
    plain, _ = time_ms(torch, ref.sax_encode_ref, xs)
    b_ms, b_by = bound(4 * (B * n + 2 * B * 16 + 255),
                       B * n + B * 16 + B * 16 * 8)
    rows.append(dict(name="sax_encode", route="cuda",
                     source="src/repro_torch/kernels/csrc/sax_encode.cu",
                     replaces="src/repro/kernels/sax_encode.py:68",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None))
    print(f"  sax_encode [64,256]: kernel {ms:.5f} ms (host {host:.4f} ms "
          f"per call), twin {plain:.5f} ms, bound {b_ms:.6f} ms ({b_by}); "
          f"symbols differing in all cases {differ}")

    # -- pairwise_l2: |err| <= 1e-5 (|q|^2 + |x|^2) --------------------------
    db0 = dev.db[0]
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
    # a fresh slab per call, as the span loop reads it: cold in L2
    n_slabs = min(n_iter, db0.shape[0] // CHUNK)
    slabs = [(qs_main, db0[i * CHUNK:(i + 1) * CHUNK]) for i in range(n_slabs)]
    ms, host = time_ms(torch, ops.pairwise_l2, slabs)
    plain, _ = time_ms(torch, ref.pairwise_l2_ref, slabs)
    lib, _ = time_ms(torch, lambda q, x: torch.cdist(q, x).square(), slabs)
    Q, X = B, CHUNK
    b_ms, b_by = bound(4 * (Q * n + X * n + Q * X),
                       2 * Q * X * n + 2 * (Q + X) * n + 4 * Q * X)
    rows.append(dict(name="pairwise_l2", route="cuda",
                     source="src/repro_torch/kernels/csrc/pairwise_l2.cu",
                     replaces="src/repro/kernels/pairwise_l2.py:61",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib))
    print(f"  pairwise_l2 [64,2048,256]: kernel {ms:.5f} ms (host {host:.4f}"
          f" ms per call), twin {plain:.5f} ms, yardstick "
          f"torch.cdist(q, x).square() {lib:.5f} ms, bound {b_ms:.6f} ms "
          f"({b_by})")

    # -- lb_paa_interval: rtol = atol = 1e-6, +inf pad leaf stays +inf -----
    paa, _ = ops.sax_encode(qs_main, 16, 8)
    lo, hi = dev.leaf_lo[0], dev.leaf_hi[0]
    rlo = torch.randn(77, 16, generator=gen, device="cuda")
    rhi = rlo + torch.randn(77, 16, generator=gen, device="cuda").abs()
    slo = torch.randn(9, 16, generator=gen, device="cuda")
    shi = slo + torch.randn(9, 16, generator=gen, device="cuda").abs()
    err = 0.0
    for a in ((paa, paa, lo, hi, n), (slo, shi, rlo, rhi, 128)):
        got = ops.lb_paa_interval(*a)
        want = ref.lb_paa_interval_ref(*a)
        torch.cuda.synchronize()
        if torch.isnan(got).any():
            fail("lb_paa_interval produced NaN")
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        fin = torch.isfinite(want)
        e = float((got[fin] - want[fin]).abs().max())
        err = max(err, e)
        print(f"  lb_paa_interval [{a[0].shape[0]},{a[2].shape[0]},"
              f"{a[0].shape[1]}]: max |err| {e:.3e}, +inf entries "
              f"{int((~fin).sum())}")
    L = lo.shape[0]
    args = [(paa, paa, lo, hi, n)] * n_iter
    ms, host = time_ms(torch, ops.lb_paa_interval, args)
    plain, _ = time_ms(torch, ref.lb_paa_interval_ref, args)
    b_ms, b_by = bound(4 * (2 * B * 16 + 2 * L * 16 + B * L),
                       7 * B * L * 16 + B * L)
    rows.append(dict(name="lb_paa_interval", route="cuda",
                     source="src/repro_torch/kernels/csrc/lb_paa_interval.cu",
                     replaces="src/repro/kernels/lb_isax.py:61",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None))
    print(f"  lb_paa_interval [64,{L},16]: kernel {ms:.5f} ms (host "
          f"{host:.4f} ms per call), twin {plain:.5f} ms, bound {b_ms:.6f} "
          f"ms ({b_by})")
    return rows


def brute_force(torch, dev, q32, k):
    """Exact top-(k+1) of ``q32 [Q, n]`` over every live row of shard 0 in
    float64 by direct differences: ``(d [Q, k+1] f64, ids [Q, k+1])``."""
    db0, ids0, alive0 = dev.db[0], dev.ids[0], dev.alive[0]
    q = q32.double()
    best_d, best_i = [], []
    step = 8192
    for c0 in range(0, db0.shape[0], step):
        x = db0[c0:c0 + step].double()
        d = ((x[None, :, :] - q[:, None, :]) ** 2).sum(-1)
        d = torch.where(alive0[c0:c0 + step][None, :], d, float("inf"))
        v, j = torch.topk(d, min(k + 1, d.shape[1]), dim=1, largest=False)
        best_d.append(v)
        best_i.append(ids0[c0:c0 + step].long()[j])
    d = torch.cat(best_d, 1)
    i = torch.cat(best_i, 1)
    v, j = torch.topk(d, k + 1, dim=1, largest=False)
    return v.sqrt(), torch.gather(i, 1, j)


def check_exact(np, ids, d, bd, bi, db, qs, k) -> int:
    """Hold one batch's result against the float64 brute force.  Distances
    agree to rtol 1e-5; an id may differ from the brute force's only where
    that position's distance is tied (within the same tolerance) with a
    neighbouring position, and then the port's id must be exactly as near.
    Returns the number of tied positions."""
    tol = 1e-5
    if not np.allclose(d.astype(np.float64), bd[:, :k], rtol=tol, atol=0):
        fail(f"distances disagree with the float64 brute force (max rel "
             f"{np.max(np.abs(d - bd[:, :k]) / bd[:, :k]):.3e})")
    tied = 0
    for qi in range(ids.shape[0]):
        if len(set(ids[qi].tolist())) != k:
            fail(f"query {qi}: ids not unique {ids[qi]}")
        for j in range(k):
            if ids[qi, j] == bi[qi, j]:
                continue
            near = [bd[qi, jj] for jj in (j - 1, j + 1) if 0 <= jj <= k]
            if not any(abs(x - bd[qi, j]) <= tol * bd[qi, j] for x in near):
                fail(f"query {qi} position {j}: id {ids[qi, j]} != brute "
                     f"force {bi[qi, j]} at an untied distance {bd[qi, j]}")
            true = np.sqrt(((db[ids[qi, j]].astype(np.float64)
                             - qs[qi].astype(np.float64)) ** 2).sum())
            if abs(true - bd[qi, j]) > tol * bd[qi, j]:
                fail(f"query {qi} position {j}: id {ids[qi, j]} at "
                     f"{true} is not tied with {bd[qi, j]}")
            tied += 1
    return tied


def profile_batch(torch, search, index, qb) -> None:
    """One batch of the main path under ``torch.profiler``: device time by
    kernel, and the device's busy share of the batch's wall time (the
    profiler's own overhead lengthens the wall time, so the share is a
    lower bound)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search(index, qb, K, chunk=CHUNK)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(getattr(e, "self_device_time_total", 0.0)
                    for e in events)
    top = sorted(events, key=lambda e: getattr(e, "self_device_time_total",
                                               0.0), reverse=True)[:10]
    print(f"  profiled batch: wall {wall:.3f} s, device busy "
          f"{device_us / 1e6:.4f} s ({100 * device_us / 1e6 / wall:.1f}% of "
          f"wall; not measured if 0)")
    for e in top:
        print(f"    {e.key[:60]:60s} calls {e.count:7d} device "
              f"{getattr(e, 'self_device_time_total', 0.0) / 1e3:9.3f} ms "
              f"host {e.self_cpu_time_total / 1e3:9.3f} ms")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-series", type=int, default=4_000_000,
                    help="collection size (default: the paper-scale 4 M)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one NVIDIA GPU")
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the repro_torch package is missing under {src}")
    sys.path.insert(0, str(src))
    import numpy as np
    from repro_torch.core.build import DumpyParams
    from repro_torch.core.index import DumpyIndex
    from repro_torch.core.sax import SaxParams, breakpoints
    from repro_torch.core.search_device import exact_search_device_batch
    from repro_torch.core.split import SplitParams
    from repro_torch.data.series import query_workload, random_walks
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import lb_isax, pairwise_l2, sax_encode

    # ---- 1. environment -------------------------------------------------
    t0 = time.perf_counter()
    smi = nvidia_smi()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}"
          f", {torch.cuda.device_count()} visible")
    phase("environment", t0)

    # ---- 2. build the kernels --------------------------------------------
    t0 = time.perf_counter()
    so, log = _build.build()
    _build.lib()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}")
    print(f"  library {so.relative_to(ROOT)}")
    phase("build kernels", t0)

    # ---- 3. data and index -------------------------------------------------
    t0 = time.perf_counter()
    db = random_walks(args.n_series, LENGTH, seed=args.seed)
    qs = query_workload(N_QUERIES, LENGTH)
    print(f"  data: {db.shape[0]} x {db.shape[1]} float32, {N_QUERIES} "
          f"held-out queries ({time.perf_counter() - t0:.3f} s)")
    t1 = time.perf_counter()
    params = DumpyParams(sax=SaxParams(w=16, b=8),
                         split=SplitParams(th=10_000))
    index = DumpyIndex.build(db, params)
    print(f"  host build: {index.flat.n_leaves} leaves, height "
          f"{index.stats.height} ({time.perf_counter() - t1:.3f} s)")
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
    qs_main = torch.from_numpy(qs[:BATCH]).cuda()
    rows = check_kernels(torch, np, ops, ref, breakpoints, qs_main, dev,
                         n_iter=50)
    phase("kernels vs twins", t0)

    # ---- 5. main path ------------------------------------------------------
    t0 = time.perf_counter()
    batches = [qs[i:i + BATCH] for i in range(0, N_QUERIES, BATCH)]
    exact_search_device_batch(index, batches[0], K, chunk=CHUNK)  # warm-up
    mods = {"sax_encode": sax_encode, "pairwise_l2": pairwise_l2,
            "lb_paa_interval": lb_isax}
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
    for name, c in launches.items():
        if c <= 0:
            fail(f"kernel {name} was not launched on the main path")

    t1 = time.perf_counter()
    tied = 0
    for qb, (ids, d, _) in zip(batches, results):
        bd, bi = brute_force(torch, dev,
                             torch.from_numpy(qb).cuda(), K)
        tied += check_exact(np, ids, d, bd.cpu().numpy(), bi.cpu().numpy(),
                            db, qb, K)
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
    profile_batch(torch, exact_search_device_batch, index, batches[1])
    phase("profile", t0)

    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
