#!/usr/bin/env python3
"""The approximate path's leaf scan: one flat view against shard by shard.

    python3 scripts/probe_leaf_scan.py [--n-series 1000000] [--device cpu]

The approximate search scans each query's routed leaf and its ``nbr - 1``
next-best leaves.  ``search_device._leaf_topk_device`` reads one flattened
``[S·Tp, n]`` view of every shard where the layout is one tensor, and
hands a placed index's schedule to ``_scan_leaf_schedule``, which visits
it shard by shard (each shard masks the leaves it does not own) and
merges the shard-local top-k lists; ``shard_by_shard`` below drives the
latter on the unplaced layout.

On a collection of random walks (w=16, b=8, th=10 000, as ``chip_smoke``
builds it) and one batch of 64 held-out queries, for ED and DTW (band 25)
at nbr 1, 4 and 16, at one shard and at four shards on one device, this
checks the two forms bitwise equal and times each: wall milliseconds a
call with the device synchronized before and after, the median of five
rounds of three calls, the two forms alternating (one call on the CPU).
The card's name and power limit are printed first.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NBRS, ROUNDS, CALLS, BATCH, BAND, K = (1, 4, 16), 5, 3, 64, 25, 10


def shard_by_shard(sd, dev, qs, prep, lbq, routed, *, k, kk, nbr, metric):
    """``_leaf_topk_device``'s schedule, scanned as a placed index's is."""
    import torch
    scores = lbq.clone()
    scores[torch.arange(qs.shape[0], device=qs.device), routed] = \
        -float("inf")
    leaves = torch.sort(scores, dim=1, stable=True).indices[:, :nbr]
    d2f, idf = sd._scan_leaf_schedule(dev, leaves, sd._gather_dist2(metric),
                                      (qs, prep), k=kk)
    return idf[:, :k], d2f[:, :k], leaves.to(torch.int32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-series", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cpu' rehearses the checks at a small size")
    args = ap.parse_args()
    import torch
    cuda = args.device != "cpu"
    if cuda and not torch.cuda.is_available():
        sys.exit("probe: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import nvidia_smi
    from repro_torch.core import search_device as sd
    from repro_torch.core.build import DumpyParams
    from repro_torch.core.index import DumpyIndex
    from repro_torch.core.metric import resolve
    from repro_torch.core.sax import SaxParams
    from repro_torch.core.split import SplitParams
    from repro_torch.data.series import query_workload, random_walks
    from repro_torch.kernels import ops

    smi = nvidia_smi() if cuda else "cpu"
    print(f"card: {smi}")
    db = random_walks(args.n_series, 256, seed=args.seed)
    qs = query_workload(BATCH, 256)
    th = 10_000 if cuda else 64
    params = DumpyParams(sax=SaxParams(w=16, b=8), split=SplitParams(th=th))
    t0 = time.perf_counter()
    index = DumpyIndex.build(db, params)
    print(f"  {args.n_series} x 256, th {th}: {index.flat.n_leaves} leaves "
          f"({time.perf_counter() - t0:.3f} s)")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def wall_ms(fn):
        calls = CALLS if cuda else 1
        sync()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        sync()
        return (time.perf_counter() - t) * 1e3 / calls

    rows = []
    for n_shards in (1, 4):
        dev = index.device_index(chunk=2048, n_shards=n_shards,
                                 device=args.device)
        q_dev = torch.from_numpy(qs).to(dev.device)
        for name in ("ed", "dtw"):
            met = resolve(name, 256, BAND if name == "dtw" else None)
            prep, sax_q = sd._prep_batch(met, q_dev, 16, 8)
            lbq = ops.lb_paa_interval(prep[0], prep[1], dev.leaf_lo_g,
                                      dev.leaf_hi_g, dev.n)
            edge_lb = ops.lb_paa_interval(prep[0], prep[1], dev.rt_lo,
                                          dev.rt_hi, dev.n)
            routed = sd._descend_device(dev, sax_q, edge_lb)
            for nbr in NBRS:
                kk = min(sd._result_margin(dev, K), nbr * dev.lmax)
                kw = dict(k=min(K, nbr * dev.lmax), kk=kk, nbr=nbr,
                          metric=met)
                a = (dev, q_dev, prep, lbq, routed)
                flat = lambda: sd._leaf_topk_device(*a, **kw)  # noqa: E731
                scan = lambda: shard_by_shard(sd, *a, **kw)  # noqa: E731
                if not all(torch.equal(x, y) for x, y in zip(flat(),
                                                             scan())):
                    sys.exit(f"probe: the two forms differ at {name} nbr "
                             f"{nbr}, {n_shards} shards")
                times = {"flat": [], "scan": []}
                for rnd in range(ROUNDS if cuda else 1):
                    order = (("flat", flat), ("scan", scan))
                    for label, fn in order[::1 if rnd % 2 == 0 else -1]:
                        times[label].append(wall_ms(fn))
                f = statistics.median(times["flat"])
                s = statistics.median(times["scan"])
                rows.append(dict(shards=n_shards, metric=name, nbr=nbr,
                                 flat_ms=f, scan_ms=s))
                print(f"  {n_shards} shard(s) {name} nbr {nbr}: bitwise "
                      f"equal; flat {f:.4f} ms, shard by shard {s:.4f} ms "
                      f"a call ({s / f:.3f}x) [{smi}]")
        del dev
        index._device_cache.clear()
    print({"leaf_scan": rows})


if __name__ == "__main__":
    main()
