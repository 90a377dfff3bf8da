"""The reference's dry-run memory plan beside the port's, cell by cell.

    PYTHONPATH=src python scripts/compare_dryrun.py --arch all \\
        --shape train_4k,prefill_32k --mesh both --jobs 6 --out build/compare

Runs on the CPU.  The reference's cells are compiled by
``repro.launch.dryrun.lower_cell`` in one child process with its own
``XLA_FLAGS`` (512 host devices); the port's are counted by
``repro_torch.launch.dryrun.lower_cell_cost`` on fake tensors, one child
process a cell, ``--jobs`` at once, with ``sites=True``: the live
storages at the port's peak grouped by the aten op and the code that made
them.  For each cell it prints each side's peak, argument, output and
temporary bytes a device and their ratio (port / reference), the port's
excess over the reference summed over the cells, the bytes live at the
port's peaks by group (:data:`CAUSES`, summed over the cells), then each
cell's largest groups at its peak.  Records go to ``<out>/ref/`` and
``<out>/port/`` (``<tag>.json`` as each dry run writes it; the port's
groups in ``<tag>.sites.json``), the table to ``<out>/compare.json`` and
``<out>/compare.md``.  ``--skip-existing`` keeps records already there
(with both sides' records there, nothing runs: the table is printed
again); ``--ref-only`` / ``--port-only`` run one side.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": ["pod_16x16"], "multi": ["multi_pod_2x16x16"],
          "both": ["pod_16x16", "multi_pod_2x16x16"]}
FIELDS = ("peak_per_device", "argument_bytes", "output_bytes", "temp_bytes")
GIB = 2 ** 30
#: the groups that hold the bytes at the port's peak: (name, shape kinds or
#: None for all, site substrings, ops or None for all), the first match
#: wins
CAUSES = (
    ("weight gradients (partial until reduced)",
     ("train",), ("MmBackward0 train.train_step._loss_and_grads",
                  "AccumulateGrad"), ("mm", "new_empty_strided")),
    ("attention chunks under autograd",
     ("train",), ("_attention_core", "common.forward", "common.backward",
                  "_repeat_kv", "_attention_chunk"), None),
    ("attention chunks without autograd",
     ("prefill",), ("_attention_core", "common.forward", "_repeat_kv",
                    "_attention_chunk"), None),
    ("prefill attention caches", ("prefill",),
     ("transformer._project_qkv", "common.rope", "transformer._cache_placed"),
     None),
    ("Griffin's scan", None, ("griffin.linear_scan", "griffin.forward",
                              "griffin.backward"), None),
    ("the loss", None, ("registry.", "LogsumexpBackward0"), None),
    ("norms", None, ("rms_norm", "layer_norm"), None),
    ("Griffin's gates", None, ("griffin._gates", "griffin._gate_math"),
     None),
    ("xLSTM's blocks", None, ("xlstm.", "common.scan", "common.<genexpr>"),
     None),
    ("arguments", None, ("",), ("argument",)),
)


def _tag(arch: str, shape: str, mesh: str) -> str:
    return f"{arch}__{shape}__{mesh}"


def ref_child(cells: list[tuple[str, str, str]], out: Path) -> None:
    """The reference's records (imports JAX: this process only)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro.launch import dryrun as ref          # sets XLA_FLAGS first
    from repro.launch.mesh import make_production_mesh
    import jax
    print(f"jax {jax.__version__}", flush=True)
    meshes = {}
    for arch, shape, mesh in cells:
        if mesh not in meshes:
            meshes[mesh] = make_production_mesh(
                multi_pod=mesh.startswith("multi"))
        t0 = time.time()
        try:
            rec = ref.lower_cell(arch, shape, meshes[mesh], mesh)
        except Exception as e:  # noqa: BLE001 — report, keep going
            rec = {"arch": arch, "shape": shape, "mesh": mesh,
                   "error": f"{type(e).__name__}: {e}"[:2000]}
        rec["jax_version"] = jax.__version__
        (out / f"{_tag(arch, shape, mesh)}.json").write_text(
            json.dumps(rec, indent=1))
        print(f"[ref] {_tag(arch, shape, mesh)} {time.time() - t0:.1f} s",
              flush=True)


def port_child(arch: str, shape: str, mesh: str, out: Path) -> None:
    """One port cell's record and its groups at the peak (no JAX)."""
    import math

    from repro_torch.distributed.sharding import fake_world
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (PRODUCTION_MESHES,
                                         production_device_mesh)
    shape_, _ = PRODUCTION_MESHES[mesh]
    t0 = time.time()
    with fake_world(math.prod(shape_)):
        dm = production_device_mesh(multi_pod=mesh.startswith("multi"),
                                    device="cpu")
        rec, cost = dryrun.lower_cell_cost(arch, shape, dm, mesh, "cpu",
                                           sites=True)
    tag = _tag(arch, shape, mesh)
    rec["count_s"] = round(time.time() - t0, 1)
    (out / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    (out / f"{tag}.sites.json").write_text(json.dumps(
        cost.peak_sites if cost is not None else [], indent=1))


def _run(cmd: list[str], env: dict, log: Path) -> int:
    with open(log, "w") as fh:
        return subprocess.run(cmd, env=env, cwd=str(ROOT), stdout=fh,
                              stderr=subprocess.STDOUT).returncode


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    return env


def run_ref(cells, out: Path) -> subprocess.Popen:
    out.mkdir(parents=True, exist_ok=True)
    env = _env(JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    spec = json.dumps(cells)
    log = open(out / "ref.log", "w")
    return subprocess.Popen([sys.executable, __file__, "--ref-child", spec,
                             "--out", str(out)], env=env, cwd=str(ROOT),
                            stdout=log, stderr=subprocess.STDOUT)


def run_port(cells, out: Path, jobs: int) -> None:
    out.mkdir(parents=True, exist_ok=True)
    env = _env()
    env.pop("XLA_FLAGS", None)

    def one(cell):
        tag = _tag(*cell)
        t0 = time.time()
        rc = _run([sys.executable, __file__, "--port-child", json.dumps(cell),
                   "--out", str(out)], env, out / f"{tag}.log")
        print(f"[port] {tag} rc={rc} {time.time() - t0:.1f} s", flush=True)
    with ThreadPoolExecutor(max(1, jobs)) as pool:
        list(pool.map(one, cells))


def _load(path: Path) -> dict | None:
    return json.loads(path.read_text()) if path.exists() else None


def compare(cells, out: Path, top: int) -> list[dict]:
    rows = []
    for arch, shape, mesh in cells:
        tag = _tag(arch, shape, mesh)
        r = _load(out / "ref" / f"{tag}.json")
        p = _load(out / "port" / f"{tag}.json")
        sites = _load(out / "port" / f"{tag}.sites.json") or []
        row = {"arch": arch, "shape": shape, "mesh": mesh}
        for side, rec in (("ref", r), ("port", p)):
            if rec is None or "memory" not in rec:
                row[side] = None if rec is None else \
                    rec.get("skipped") or rec.get("error")
                continue
            row[side] = {k: rec["memory"][k] for k in FIELDS}
        if isinstance(row["ref"], dict) and isinstance(row["port"], dict):
            row["ratio"] = {k: (row["port"][k] / row["ref"][k]
                                if row["ref"][k] else None) for k in FIELDS}
        if p is not None:
            row["count_s"] = p.get("count_s")
        row["sites"] = sites[:top]
        rows.append(row)
    return rows


def cause_of(kind: str, op: str, site: str) -> str:
    """The :data:`CAUSES` entry a group at the peak belongs to."""
    for name, kinds, sites, ops in CAUSES:
        if (kinds is None or kind in kinds) and \
                (ops is None or op in ops) and any(x in site for x in sites):
            return name
    return "other"


def causes(cells, out: Path) -> list[tuple[str, float]]:
    """Bytes at the port's peak by group, summed over the cells (every
    group of each cell's ``<tag>.sites.json``), largest first."""
    total: dict[str, float] = {}
    for arch, shape, mesh in cells:
        kind = shape.split("_")[0]
        for e in _load(out / "port" / f"{_tag(arch, shape, mesh)}"
                                      ".sites.json") or []:
            c = cause_of(kind, e["op"], e["site"])
            total[c] = total.get(c, 0.0) + e["bytes"]
    return sorted(total.items(), key=lambda e: -e[1])


def _gib(x) -> str:
    return f"{x / GIB:.2f}" if isinstance(x, (int, float)) else "—"


def report(rows: list[dict], out: Path, jax_version: str | None,
           by_cause: list[tuple[str, float]]) -> None:
    lines = [f"reference under jax {jax_version}; GiB a device; "
             "ratio = port / reference", "",
             "| cell | peak ref / port (ratio) | arguments ref / port | "
             "outputs ref / port | temporaries ref / port | port count s |",
             "|---|---|---|---|---|---|"]
    for row in rows:
        r, p = row["ref"], row["port"]
        name = f"{row['arch']} {row['shape']} {row['mesh']}"
        if not (isinstance(r, dict) and isinstance(p, dict)):
            lines.append(f"| {name} | ref: {r} / port: {p} | | | | |")
            continue
        ratio = row["ratio"]["peak_per_device"]
        cols = [f"{_gib(r[k])} / {_gib(p[k])}" for k in FIELDS[1:]]
        lines.append(f"| {name} | {_gib(r['peak_per_device'])} / "
                     f"{_gib(p['peak_per_device'])} ({ratio:.2f}) | "
                     + " | ".join(cols) + f" | {row.get('count_s')} |")
    both = [r for r in rows if isinstance(r["ref"], dict) and
            isinstance(r["port"], dict)]
    over = sum(max(0, r["port"]["peak_per_device"] -
                   r["ref"]["peak_per_device"]) for r in both)
    lines += ["", f"port over the reference, summed over {len(both)} "
              f"cells: {over / GIB:.2f} GiB", "",
              "| live at the port's peak, by group | GiB, summed over the "
              "cells |", "|---|---|"]
    lines += [f"| {name} | {b / GIB:.2f} |" for name, b in by_cause]
    text = "\n".join(lines)
    print(text)
    for row in rows:
        if not row["sites"]:
            continue
        print(f"\n{row['arch']} {row['shape']} {row['mesh']}: live at the "
              "port's peak, by aten op and site")
        for e in row["sites"]:
            print(f"  {e['bytes'] / GIB:9.3f} GiB  {e['op']:<28} {e['site']}")
    (out / "compare.md").write_text(text + "\n")
    (out / "compare.json").write_text(json.dumps(
        {"jax_version": jax_version, "rows": rows,
         "causes": dict(by_cause)}, indent=1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="train_4k,prefill_32k")
    ap.add_argument("--mesh", default="both", choices=sorted(MESHES))
    ap.add_argument("--jobs", type=int, default=4,
                    help="port cells counted at once (one process each)")
    ap.add_argument("--top", type=int, default=12,
                    help="groups printed a cell")
    ap.add_argument("--out", default="build/compare_dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--ref-only", action="store_true")
    ap.add_argument("--port-only", action="store_true")
    ap.add_argument("--ref-child", help=argparse.SUPPRESS)
    ap.add_argument("--port-child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    out = Path(args.out)
    if args.ref_child:
        return ref_child([tuple(c) for c in json.loads(args.ref_child)], out)
    if args.port_child:
        return port_child(*json.loads(args.port_child), out)

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.models import registry
    archs = (list(registry.ARCH_NAMES) if args.arch == "all"
             else args.arch.split(","))
    cells = [(a, s, m) for m in MESHES[args.mesh] for a in archs
             for s in args.shape.split(",")]

    def todo(side):
        return [c for c in cells if not (args.skip_existing and (
            out / side / f"{_tag(*c)}.json").exists())]
    ref_proc = None
    if not args.port_only and todo("ref"):
        ref_proc = run_ref(todo("ref"), out / "ref")
    if not args.ref_only:
        run_port(todo("port"), out / "port", args.jobs)
    if ref_proc is not None and ref_proc.wait() != 0:
        print(f"reference child failed: see {out / 'ref' / 'ref.log'}")
    versions = {rec.get("jax_version") for c in cells
                if (rec := _load(out / "ref" / f"{_tag(*c)}.json"))}
    report(compare(cells, out, args.top), out,
           ",".join(sorted(v for v in versions if v)) or None,
           causes(cells, out))


if __name__ == "__main__":
    main()
