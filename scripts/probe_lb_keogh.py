#!/usr/bin/env python3
"""Where the ``lb_keogh`` kernel's time goes, on one NVIDIA GPU.

    python3 scripts/probe_lb_keogh.py [--with NAME=path/to/kernel.cu ...]

Builds ``src/repro_torch/kernels/csrc/lb_keogh.cu`` and copies of it made
by editing its source:

* ``no_math`` (copies, barriers and the epilogue, without the column loop),
  ``no_copy`` (the shared reads and arithmetic on whatever shared memory
  holds, without the copies) and ``neither`` (the launch, the barriers, the
  epilogue and the stores) split the kernel's time and compute nothing
  useful;
* ``no_zero_max`` (``d = max(x - U, L - x)``, one FMNMX fewer an element;
  wrong where x lies inside the envelope) and ``clamp`` (``d = x -
  min(max(x, L), U)``, four instructions, equal only where L <= U) show what
  an instruction of the element costs;
* ``tile32``, ``tile16`` and ``tile8`` take the shared layout's tile of 32,
  16 or 8 queries x 32 candidates (4 x 4, 2 x 4 and 1 x 4 register tiles)
  at every shape, where the launcher chooses between 32 and 8 by the
  number of blocks: the same sums, one, two and four times the blocks;
* ``ahead1``, ``ahead2`` and ``ahead3`` request 1, 2 or 3 chunks ahead of
  the one being summed, where the kernel requests 7;
* ``x_first`` issues each chunk's candidate-row copies before its
  envelope rows', and ``kc64`` stages 64-column chunks in a ring of 4 (the
  same shared memory, half the barriers).

``--with`` adds another source with the same C entry point (an earlier
commit's kernel, say).  Every variant that claims the kernel's values is
held against a float64 LB_Keogh first.  Each is timed at the lane program's
slab [64, 2048, 256] (a cold 2048-row slab per call), at the ``shared``
order's sub-slab [64, 256, 256], and in the per-query layout at the lane
walk's gathered chunk [64, 128, 256]: CUDA events around 50 calls queued
behind a held stream (``chip_smoke.time_ms``), in four rounds of
alternating order; then ``torch.profiler``'s device time of the kernel
alone at the slab.  ``--sass`` prints the opcode counts of each variant's
shared-layout 16-byte instance with 32-query tiles (``cuobjdump -sass``).  The card's name and
power limit are printed first and last.  Builds go to ``build/probe/``.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "lb_keogh.cu"
OUT = ROOT / "build" / "probe"
Q, M, N, SUB, GATHER, CALLS = 64, 2048, 256, 256, 128, 50

MATH_LOOP = "for (int g = 0; g < KC / 4 / CLASSES; ++g) {"
COPY = "load_chunk<VEC, T>(smem"
ELEMENT = "fmaxf(fmaxf(__fsub_rn(v, u), __fsub_rn(lo, v)), 0.f)"
CHOICE = "if (2 * blocks_of(32, 32, Q, m) >= sm_count[dev & 63])"
SMALL = "return launch<VEC, SharedTile<8>>"
AHEAD = "constexpr int AHEAD = NS - 1;"
ROW = "const int r = idx / PER_ROW;"
CHUNK = ("constexpr int KC = 32;", "constexpr int NS = 8;")


def variants(src: str) -> tuple[dict[str, str], set[str]]:
    """The probe's sources, and the names of those that must give the
    kernel's values."""
    for cut in (MATH_LOOP, COPY, ELEMENT, CHOICE, SMALL, AHEAD, ROW, *CHUNK):
        if cut not in src:
            sys.exit(f"probe: {cut!r} not found in {SRC}; update the probe")
    no_math = src.replace(MATH_LOOP, "for (int g = 0; g < 0; ++g) {")

    def ahead(a: int) -> str:
        return src.replace(AHEAD, f"constexpr int AHEAD = {a};")

    out = {"kernel": src, "no_math": no_math,
           "no_copy": src.replace(COPY, "if (false) " + COPY),
           "neither": no_math.replace(COPY, "if (false) " + COPY),
           "no_zero_max": src.replace(
               ELEMENT, "fmaxf(__fsub_rn(v, u), __fsub_rn(lo, v))"),
           "clamp": src.replace(
               ELEMENT, "__fsub_rn(v, fminf(fmaxf(v, lo), u))"),
           "tile32": src.replace(CHOICE, "if (true)"),
           "tile16": src.replace(CHOICE, "if (false)").replace(
               SMALL, SMALL.replace("<8>", "<16>")),
           "tile8": src.replace(CHOICE, "if (false)"),
           "ahead1": ahead(1), "ahead2": ahead(2), "ahead3": ahead(3),
           "x_first": src.replace(ROW, "const int r = (idx / PER_ROW + 2 * "
                                  "T::TQ) % (2 * T::TQ + T::XROWS);"),
           "kc64": src.replace(CHUNK[0], "constexpr int KC = 64;").replace(
               CHUNK[1], "constexpr int NS = 4;")}
    return out, set(out) - {"no_math", "no_copy", "neither", "no_zero_max"}


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-shared", str(cu), "-o",
             str(OUT / f"lib{name}.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"probe: nvcc failed on {name}:\n{log}")
        used = [ln.split(":", 1)[1].strip() if ":" in ln else ln.strip()
                for ln in log.splitlines()
                if ("Used" in ln and "registers" in ln)
                or ("spill" in ln and " 0 bytes spill stores" not in ln)]
        print(f"  {name}: ptxas {used}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        lib.dumpy_lb_keogh_f32.argtypes = \
            _build._SIGNATURES["dumpy_lb_keogh_f32"]
        libs[name] = lib
    return libs


def sass_counts(name: str) -> None:
    """Opcode counts of the shared-layout 16-byte instance (32-query
    tiles) of ``name``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(OUT / f"lib{name}.so")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        print(f"  {name}: cuobjdump failed: {res.stderr.strip()[:200]}")
        return
    funcs = [f for f in res.stdout.split("Function :")[1:]
             if "lb_keogh_kernelILb1E" in f.split("\n", 1)[0]
             and "SharedTileILi32E" in f.split("\n", 1)[0]]
    if not funcs:
        print(f"  {name}: shared 16-byte instance not found in the SASS")
        return
    text = funcs[0]
    ops = collections.Counter(
        m.group(1).split(".")[0] for m in
        re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)",
                    text))
    total = sum(ops.values())
    print(f"  {name}: {total} SASS instructions; "
          + ", ".join(f"{k} {v}" for k, v in ops.most_common(14)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--with", dest="extra", action="append", default=[],
                    metavar="NAME=PATH", help="another kernel source")
    ap.add_argument("--sass", action="store_true",
                    help="print each variant's SASS opcode counts")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("probe: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import nvidia_smi, time_ms
    print(f"card: {nvidia_smi()}")
    sources, exact = variants(SRC.read_text())
    for item in args.extra:
        name, path = item.split("=", 1)
        sources[name] = Path(path).read_text()
        exact.add(name)
    libs = build(sources)
    if args.sass:
        for name in libs:
            sass_counts(name)

    from repro_torch.core.lb import dtw_envelope_batch
    gen = torch.Generator(device="cuda").manual_seed(0)
    qs = torch.randn(Q, N, generator=gen, device="cuda").cumsum(1)
    U, L = (t.contiguous() for t in dtw_envelope_batch(qs, 25))
    U[:, [0, -1]], L[:, [0, -1]] = float("inf"), -float("inf")
    db = torch.randn(CALLS * M, N, generator=gen, device="cuda").cumsum(1)
    idx = torch.randint(0, M, (Q, GATHER), generator=gen, device="cuda")
    out = torch.empty(Q, M, device="cuda")

    def call(lib):
        def run(x):
            err = lib.dumpy_lb_keogh_f32(
                x.data_ptr(), U.data_ptr(), L.data_ptr(), out.data_ptr(), Q,
                x.shape[-2], N, x.shape[-2] if x.dim() == 3 else 0,
                torch.cuda.current_stream().cuda_stream)
            if err:
                sys.exit(f"probe: launch failed with error {err}")
        return run

    x = db[:M].double()
    d = torch.maximum((x[None] - U.double()[:, None]).clamp_min(0),
                      (L.double()[:, None] - x[None]).clamp_min(0))
    want = (d * d).sum(-1)
    for name in sorted(exact & set(libs)):
        call(libs[name])(db[:M])
        torch.cuda.synchronize()
        rel = float(((out.double() - want).abs()
                     / want.clamp_min(1e-30)).max())
        print(f"  {name}: max rel err against float64 {rel:.3e}")
        if rel > 1e-5:
            sys.exit(f"probe: {name} is wrong")

    shapes = {
        "slab [64,2048,256]": [(db[i * M:(i + 1) * M],)
                               for i in range(CALLS)],
        "sub-slab [64,256,256]": [(db[i * SUB:(i + 1) * SUB],)
                                  for i in range(CALLS)],
        "gathered [64,128,256]": [(db[i * M:(i + 1) * M][idx].contiguous(),)
                                  for i in range(CALLS)]}
    for label, args_list in shapes.items():
        times = {name: [] for name in libs}
        for rnd in range(4):
            order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
            for name in order:
                times[name].append(
                    time_ms(torch, call(libs[name]), args_list)[0])
        print(f"  {label}, ms per call (events, 4 rounds):")
        for name, ts in times.items():
            print(f"    {name:12s} " + " ".join(f"{t:.5f}" for t in ts)
                  + f"; min {min(ts):.5f}")
    from torch.profiler import ProfilerActivity, profile
    for name, lib in libs.items():
        run = call(lib)
        for a in shapes["slab [64,2048,256]"][:3]:
            run(*a)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for a in shapes["slab [64,2048,256]"]:
                run(*a)
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if "lb_keogh_kernel" in e.key]
        kern = (sum(e.self_device_time_total for e in hits)
                / max(sum(e.count for e in hits), 1) / 1e3)
        print(f"  {name:12s} slab, kernel alone (profiler) {kern:.5f} ms")
    print(f"card: {nvidia_smi()}")


if __name__ == "__main__":
    main()
