"""Contract audit CLI (port of ``repro.analysis.audit``).

::

    PYTHONPATH=src python -m repro_torch.analysis.audit --device cpu    # gate
    PYTHONPATH=src python -m repro_torch.analysis.audit --device cpu --update
    PYTHONPATH=src python -m repro_torch.analysis.audit --only serving_bucket
    python -m repro_torch.analysis.audit                # on the card (CUDA)

Runs every entry of :mod:`repro_torch.analysis.registry` at the audit
shapes under a census (:mod:`repro_torch.analysis.contracts`) and checks
the contracts against the golden ``contracts_torch.json`` beside this
module, which is extracted on the CPU and records the torch version.

* ``--device cpu`` diffs every contract against the golden (``aten_ops``
  only under the golden's torch version; otherwise the skip is printed).
* ``--device cuda`` (the default): for ``shape_fixed`` entries the card's
  ``kernel_calls`` must equal the golden's and its ``host_syncs`` (the
  ``set_sync_debug_mode`` warnings) the CPU's prediction in the golden; for
  the others, whose loops stop on their data, the card's counts are
  printed beside the golden's.

Exit 1 on (a) policy violations (float64 on a device path, a host sync in
a sync-free entry, a device move in a shard-local one — never blessable),
(b) undeclared drift, (c) stale or missing golden entries.  ``--update``
rewrites the golden from a CPU extraction; policy violations still fail
under it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

GOLDEN_PATH = Path(__file__).resolve().parent / "contracts_torch.json"
#: the fields the card is held to, for ``shape_fixed`` entries
CARD_KEYS = ("kernel_calls", "host_syncs")


def _golden_payload(results: dict) -> dict:
    import torch

    from . import registry
    return {
        "_meta": {
            "tool": "python -m repro_torch.analysis.audit --device cpu "
                    "--update",
            "torch": torch.__version__,
            "device": "cpu",
            "audit_shapes": dict(registry.AUDIT_SHAPES,
                                 k=registry.AUDIT_K, nbr=registry.AUDIT_NBR,
                                 q_batch=registry.AUDIT_Q_BATCH,
                                 seed=registry.AUDIT_SEED),
            "serving_shapes": dict(registry.SERVING_SHAPES,
                                   th=registry.SERVING_TH),
        },
        "programs": {name: {k: v for k, v in c.items() if k != "peak_bytes"}
                     for name, c in results.items()},
    }


def summary(c: dict) -> str:
    """One line of a contract's counts."""
    peak = ("-" if c.get("peak_bytes") is None
            else f"{c['peak_bytes'] / 2**20:.1f}MiB")
    return (f"kernels={sum(c['kernel_calls']['histogram'].values()):4d} "
            f"eager={c['eager_launches']:5d} "
            f"syncs={sum(c['host_syncs'].values()):3d} "
            f"dtypes={','.join(c['dtypes'])} peak={peak}")


def check(results: dict, device: str, golden: dict | None,
          names=None) -> tuple[list[str], list[str], list[str]]:
    """``(policy problems, drift lines, notes)`` of extracted ``results``
    (``{name: contract}``) against the ``golden`` payload."""
    from . import contracts, registry
    problems, drift, notes = [], [], []
    for e in registry.entries(list(results)):
        problems += contracts.policy_violations(e, results[e.name])
    if golden is None:
        return problems, drift, notes
    programs = golden.get("programs", {})
    cpu = device == "cpu"
    skip = contracts.aten_skip_reason(golden.get("_meta", {}).get("torch"))
    if cpu and skip:
        notes.append(skip)
    for e in registry.entries(list(results)):
        g = programs.get(e.name)
        if g is None:
            drift.append(f"{e.name}: not in golden (new entry? bless with "
                         f"--update)")
            continue
        if cpu:
            drift += contracts.diff_contract(e.name, g, results[e.name],
                                             compare_aten=skip is None)
        elif e.shape_fixed:
            drift += contracts.diff_contract(e.name, g, results[e.name],
                                             keys=CARD_KEYS)
        else:
            c = results[e.name]
            notes.append(
                f"{e.name}: card kernels "
                f"{c['kernel_calls']['histogram']} syncs {c['host_syncs']}"
                f" | CPU golden kernels {g['kernel_calls']['histogram']} "
                f"syncs {g['host_syncs']} (data-dependent loops: printed, "
                f"not compared)")
    if names is None:
        for stale in sorted(set(programs) - set(results)):
            drift.append(f"{stale}: in golden but not registered (deleted "
                         f"entry? bless with --update)")
    return problems, drift, notes


def run_audit(update: bool = False, names=None, device: str = "cuda",
              golden_path: Path = GOLDEN_PATH, verbose: bool = True,
              results: dict | None = None) -> int:
    """The gate; returns the exit code.  ``results`` (``{name: contract}``)
    skips the extraction."""
    from . import contracts
    t0 = time.time()
    if update and device != "cpu":
        print("AUDIT FAIL: the golden is extracted on the CPU (--device "
              "cpu --update)", file=sys.stderr)
        return 1
    if results is None:
        from . import registry
        results = {}
        for e in registry.entries(names):
            t1 = time.time()
            results[e.name] = contracts.run_entry(e, device)[1].contract()
            if verbose:
                print(f"[audit] {e.name:26s} {time.time() - t1:5.2f}s "
                      f"{summary(results[e.name])}", flush=True)
    golden = None
    if not update:
        try:
            golden = json.loads(golden_path.read_text())
        except (OSError, ValueError):
            print(f"AUDIT FAIL: no readable golden at {golden_path}; run "
                  f"`python -m repro_torch.analysis.audit --device cpu "
                  f"--update` and commit it", file=sys.stderr)
            return 1
    problems, drift, notes = check(results, device, golden, names)
    for p in problems:
        print(f"POLICY: {p}", file=sys.stderr)
    if update:
        if names is not None:
            try:
                payload = json.loads(golden_path.read_text())
            except (OSError, ValueError):
                payload = _golden_payload({})
            payload["programs"].update(_golden_payload(results)["programs"])
            payload["_meta"] = _golden_payload({})["_meta"]
        else:
            payload = _golden_payload(results)
        golden_path.write_text(json.dumps(payload, indent=1, sort_keys=True)
                               + "\n")
        print(f"[audit] wrote {len(payload['programs'])} contract(s) to "
              f"{golden_path} in {time.time() - t0:.1f}s")
        return 1 if problems else 0
    for n in notes:
        print(f"[audit] {n}")
    for d in drift:
        print(f"DRIFT: {d}", file=sys.stderr)
    n_bad = len(problems) + len(drift)
    print(f"[audit] {'FAIL' if n_bad else 'PASS'} on {device}: "
          f"{len(results)} entr{'y' if len(results) == 1 else 'ies'}, "
          f"{len(problems)} policy violation(s), {len(drift)} drift line(s) "
          f"in {time.time() - t0:.1f}s")
    if drift:
        print("[audit] intended change? re-bless with `python -m "
              "repro_torch.analysis.audit --device cpu --update` and "
              "declare it")
    return 1 if n_bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="contract audit over every registered entry point")
    ap.add_argument("--update", action="store_true",
                    help="re-bless the golden from a CPU extraction")
    ap.add_argument("--only", action="append", metavar="NAME",
                    help="audit only NAME (repeatable)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--golden", type=Path, default=GOLDEN_PATH)
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    return run_audit(update=args.update, names=args.only, device=args.device,
                     golden_path=args.golden, verbose=not args.quiet)


if __name__ == "__main__":
    sys.exit(main())
