"""Fault-injection smoke of the robustness substrate (port of
``repro.robustness.smoke``)::

    python -m repro_torch.robustness.smoke               # on the GPU
    python -m repro_torch.robustness.smoke --device cpu  # plain versions

Two fast end-to-end checks, exit 0/1:

1. **Crash-on-commit recovery** — save an index, insert a batch (WAL),
   crash an overwriting save at the ``index.save.commit`` failpoint,
   reload: the previous generation plus its WAL must reproduce the full
   pre-crash state, and an exact search on ``device`` must find a
   recovered series at distance 0; a follow-up save must succeed and load
   clean.
2. **Degraded search** — 4-way sharded exact search on ``device`` with one
   dead shard must report the reachable-live coverage and return results
   bitwise equal to a host brute force restricted to the surviving shards.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np


def _check(ok: bool, label: str) -> bool:
    print(f"[robustness-smoke] {'ok  ' if ok else 'FAIL'} {label}")
    return ok


def crash_on_commit_smoke(device: str = "cuda") -> bool:
    from repro_torch.core.build import DumpyParams
    from repro_torch.core.index import DumpyIndex
    from repro_torch.core.search_device import exact_search_device_batch
    from repro_torch.robustness import failpoints as fp

    rng = np.random.default_rng(0)
    db = rng.normal(size=(400, 64)).astype(np.float32)
    idx = DumpyIndex.build(db, DumpyParams())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "idx")
        idx.save(path)
        idx.insert_many(rng.normal(size=(7, 64)).astype(np.float32))
        crashed = False
        try:
            with fp.armed({"index.save.commit": "crash"}):
                idx.save(path)
        except fp.InjectedCrash:
            crashed = True
        ok = _check(crashed, "save crashed at the commit failpoint")
        re = DumpyIndex.load(path)
        ok &= _check(re.db.shape[0] == 407
                     and np.array_equal(re.db, idx.db),
                     "reload recovered the WAL batch after the crash")
        ids, d, _ = exact_search_device_batch(re, re.db[403:404], 1,
                                              device=device)
        ok &= _check(int(ids[0, 0]) == 403 and float(d[0, 0]) == 0.0,
                     f"exact search on {device} finds a recovered series")
        re.save(path)
        re2 = DumpyIndex.load(path)
        ok &= _check(np.array_equal(re2.db, idx.db),
                     "post-crash save committed and loads clean")
    return ok


def degraded_search_smoke(device: str = "cuda") -> bool:
    from repro_torch.core.build import DumpyParams
    from repro_torch.core.index import DumpyIndex
    from repro_torch.core.sax import SaxParams
    from repro_torch.core.search_device import exact_search_device_batch
    from repro_torch.core.split import SplitParams

    rng = np.random.default_rng(1)
    db = rng.normal(size=(2000, 64)).astype(np.float32)
    params = DumpyParams(sax=SaxParams(w=8, b=8), split=SplitParams(th=64))
    idx = DumpyIndex.build(db, params)
    qs = rng.normal(size=(4, 64)).astype(np.float32)
    dev = idx.device_index(n_shards=4, device=device)
    health = (True, True, True, False)
    ids, d, _, cov = exact_search_device_batch(idx, qs, 10, dev=dev,
                                               shard_health=health)

    order = np.asarray(idx.flat.order)
    rb = dev.row_bounds
    surviving = np.zeros(db.shape[0], bool)
    for s, h in enumerate(health):
        if h:
            surviving[order[rb[s]:rb[s + 1]]] = True
    ok = _check(0.0 < cov < 1.0 and cov == surviving.mean(),
                f"coverage {cov:.3f} matches the surviving-shard fraction")

    sub = np.where(surviving)[0]
    dist = np.sqrt(((db[sub][None, :, :] - qs[:, None, :]) ** 2)
                   .sum(-1)).astype(np.float32)
    for q in range(len(qs)):
        perm = np.lexsort((sub, dist[q]))[:10]
        if not (np.array_equal(sub[perm], ids[q])
                and np.array_equal(dist[q][perm].astype(np.float32), d[q])):
            return _check(False, f"degraded parity (query {q})") and ok
    return _check(True, "degraded results bitwise = restricted host "
                        "search") and ok


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the searches run (default: cuda)")
    args = ap.parse_args(argv)
    ok = crash_on_commit_smoke(args.device)
    ok &= degraded_search_smoke(args.device)
    print(f"[robustness-smoke] {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
