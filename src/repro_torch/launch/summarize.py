"""Aggregate dry-run artifacts into the §Roofline tables (copy of
``repro.launch.summarize``).

    PYTHONPATH=src python -m repro_torch.launch.summarize [--dir artifacts/dryrun]

Pure Python over JSON records: the port's own dry-run records
(``repro_torch.launch.dryrun``: H100 roofline terms, per-device bytes from
``distributed.op_cost``), or the reference's XLA records, which have the
same keys (``cost_xla_raw`` where the port has ``cost_raw``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def load(dirname: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as fh:
            recs.append(json.load(fh))
    return recs


def roofline_table(recs: list[dict], mesh: str) -> str:
    rows = ["| arch | shape | compute | memory | collective | bottleneck | "
            "step bound | roofline frac | useful ratio | HBM GiB/dev |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if "skipped" in r:
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"skipped | — | — | — | — |")
            continue
        if "error" in r:
            rows.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | | |")
            continue
        rl = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rl['compute_s'])} | "
            f"{fmt_s(rl['memory_s'])} | {fmt_s(rl['collective_s'])} | "
            f"{rl['bottleneck']} | {fmt_s(rl['step_s'])} | "
            f"{rl['roofline_fraction']:.2f} | {rl['useful_ratio']:.2f} | "
            f"{r['memory']['peak_per_device']/2**30:.1f} |")
    return "\n".join(rows)


def dryrun_table(recs: list[dict]) -> str:
    rows = ["| arch | shape | mesh | compile | HBM/dev GiB | colls/step | "
            "coll GB/dev | status |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if "skipped" in r:
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — "
                        f"| — | — | skipped ({r['skipped'][:40]}…) |")
            continue
        if "error" in r:
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — "
                        f"| — | — | ERROR {r['error'][:60]} |")
            continue
        nc = sum(v["count"] for v in r["collectives"]["per_kind"].values())
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['compile_s']}s | "
            f"{r['memory']['peak_per_device']/2**30:.1f} | {nc:.0f} | "
            f"{r['collectives']['total_bytes']/2**30:.2f} | ok |")
    return "\n".join(rows)


def pick_hillclimb(recs: list[dict]) -> list[str]:
    """Worst roofline fraction / most collective-bound / decode (retrieval-
    serving, the paper-technique host) among single-pod cells."""
    ok = [r for r in recs if "roofline" in r and r["mesh"] == "pod_16x16"]
    worst = min(ok, key=lambda r: r["roofline"]["roofline_fraction"])
    coll = max(ok, key=lambda r: (r["roofline"]["collective_s"] /
                                  max(r["roofline"]["step_s"], 1e-12)))
    dec = [r for r in ok if r["shape"] == "decode_32k"]
    rep = max(dec, key=lambda r: r["roofline"]["step_s"]) if dec else worst
    return [f"{worst['arch']}__{worst['shape']} (worst fraction "
            f"{worst['roofline']['roofline_fraction']:.3f})",
            f"{coll['arch']}__{coll['shape']} (most collective-bound "
            f"{coll['roofline']['collective_s']/max(coll['roofline']['step_s'],1e-12):.2f})",
            f"{rep['arch']}__{rep['shape']} (heaviest decode — retrieval-"
            f"serving host for the paper's kNN application)"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    args = ap.parse_args()
    recs = load(args.dir)
    print("## §Dry-run\n")
    print(dryrun_table(recs))
    print("\n## §Roofline (single pod 16×16)\n")
    print(roofline_table(recs, "pod_16x16"))
    print("\n## §Roofline (multi-pod 2×16×16)\n")
    print(roofline_table(recs, "multi_pod_2x16x16"))
    print("\n## Hillclimb picks\n")
    for p in pick_hillclimb(recs):
        print("-", p)


if __name__ == "__main__":
    main()
