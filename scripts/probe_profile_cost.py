#!/usr/bin/env python3
"""What one profiled batch costs on the host, split into its parts.

    python3 scripts/probe_profile_cost.py [--n-series 4000000] [--device cpu]

``chip_smoke.py``'s phases 6 and 8 run one exact batch under
``torch.profiler`` (CPU and CUDA activities) and read ``key_averages()``;
each phase takes ten to twenty times the batch's own wall time.  On the
collection ``chip_smoke`` builds (random walks, seed 0, w=16, b=8,
th=10 000, chunk 2048) and its held-out queries, this times, for exact ED
(queries 64–127, phase 6's batch) and exact DTW (band 25, order
"cluster", queries 64–127, phase 8's batch, and its first 32 queries):
the batch alone, then under the profiler the search, the profiler's exit
(it parses the trace there), the same rows summed by hand over
``events()`` (count, self device and self host time by key and device
type) and ``key_averages()``, each on the host's clock, with the number
of events; once with both activities, as
``chip_smoke``, and once with the CUDA activity alone.  Host seconds:
the profiler's work is on the host.  The card's name and power limit are
printed first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
K, CHUNK, BAND, LENGTH = 10, 2048, 25, 256


def profiled(torch, search, activities) -> dict:
    """``search()`` under the profiler: seconds of each part."""
    from torch.profiler import profile
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        t1 = time.perf_counter()
        search()                 # returns host arrays: the device is done
        t2 = time.perf_counter()
    t3 = time.perf_counter()
    rows: dict = {}
    for e in prof.events():
        row = rows.setdefault((e.key, e.device_type), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += e.self_device_time_total
        row[2] += e.self_cpu_time_total
    t4 = time.perf_counter()
    prof.key_averages()
    t5 = time.perf_counter()
    return {"enter_s": t1 - t0, "search_s": t2 - t1, "exit_s": t3 - t2,
            "by_hand_s": t4 - t3, "key_averages_s": t5 - t4,
            "events": len(prof.events())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-series", type=int, default=4_000_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity

    from repro_torch.core.build import DumpyParams
    from repro_torch.core.index import DumpyIndex
    from repro_torch.core.sax import SaxParams
    from repro_torch.core.search_device import exact_search_device_batch
    from repro_torch.core.split import SplitParams
    from repro_torch.data.series import query_workload, random_walks

    cuda = args.device == "cuda"
    if cuda:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    db = random_walks(args.n_series, LENGTH, seed=0)
    qs = query_workload(128, LENGTH)
    index = DumpyIndex.build(db, DumpyParams(sax=SaxParams(w=16, b=8),
                                             split=SplitParams(th=10_000)))
    dev = index.device_index(chunk=CHUNK, device=args.device)
    sync()
    print(f"set-up {time.perf_counter() - t0:.3f} s "
          f"({args.n_series} x {LENGTH}, {dev.win_start.shape[1]} spans)")
    both = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    acts = {"cpu+cuda": both}
    if cuda:
        acts["cuda"] = [ProfilerActivity.CUDA]
    cases = (("exact ED, 64 queries", qs[64:128], {}),
             ("exact DTW cluster, 64 queries", qs[64:128],
              dict(metric="dtw", band=BAND, order="cluster")),
             ("exact DTW cluster, 32 queries", qs[64:96],
              dict(metric="dtw", band=BAND, order="cluster")))
    for label, qb, kw in cases:
        def search(qb=qb, kw=kw):
            return exact_search_device_batch(index, qb, K, chunk=CHUNK,
                                             dev=dev, **kw)
        search()                                           # warm
        t1 = time.perf_counter()
        search()
        print(f"{label}: the batch alone {time.perf_counter() - t1:.3f} s")
        for name, a in acts.items():
            r = profiled(torch, search, a)
            total = sum(v for key, v in r.items() if key.endswith("_s"))
            print(f"  profiled ({name}): " + ", ".join(
                f"{key} {v:.3f}" for key, v in r.items() if key != "events")
                + f"; {r['events']} events; {total:.3f} s in all")


if __name__ == "__main__":
    main()
