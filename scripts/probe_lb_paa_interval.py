#!/usr/bin/env python3
"""Where the ``lb_paa_interval`` kernel's time goes, on one NVIDIA GPU.

    python3 scripts/probe_lb_paa_interval.py [--sass] [--with NAME=file.cu]

Builds ``src/repro_torch/kernels/csrc/lb_paa_interval.cu`` and copies of it
made by editing its source:

* ``no_math`` (leaf loads, query staging, the launch; no sums, no stores)
  and ``no_store`` (the sums without the stores of the bounds) split the
  kernel's time and compute nothing useful;
* ``math_only`` (the sums, stored only where their total is -1, never)
  and ``aligned_rows`` (the bounds at a row stride rounded up to 32
  floats, so every row starts on a 128-byte line) and ``stream`` (the
  stores as ``__stcs``, evict-first) split the rest;
* ``five`` (``d = max(lo - qh, ql - hi)``, one FMNMX fewer an element;
  wrong where the intervals overlap) shows what an instruction of the
  element costs;
* ``fma`` (``fmaf(d, d, acc)``, one rounding fewer: other bits) and
  ``one_sub`` (``d = max(lo - qh, ql, 0)``, one FADD fewer: wrong) show
  what the float32 pipe's share costs;
* ``r2`` (two leaves a thread, the first layout), ``lb64`` (at most 64
  registers a thread), ``qi2`` / ``qi8`` (2 or 8 queries summed at once
  where the kernel sums 4), ``t128`` (blocks of 128 threads where it
  takes 64), ``qpb16`` / ``qpb128`` (at most 16 or 128 queries a block
  where it takes 64): the same bounds, other maps.

``--with`` adds another source with the same C entry point (an earlier
commit's kernel, say).  Every variant that claims the kernel's values is
held bitwise against ``ref.lb_paa_interval_in_order``
first.  Each is timed at the search's shape [64, 757, 16] and at a 100 M
series collection's table [256, 18 925, 16] (random intervals, the last
leaf +inf): CUDA events around 50 calls queued behind a held stream
(``chip_smoke.time_ms``), in four rounds of alternating order, then
``torch.profiler``'s device time of the kernel alone at the large shape;
the SM clock is read (``nvidia-smi``) while the kernel runs back to back.
``--sass`` prints the opcode counts of each variant's w = 16 instance
(``cuobjdump -sass``).  The card's name and power limit are printed first
and last.  Builds go to ``build/probe/``.
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
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "lb_paa_interval.cu"
OUT = ROOT / "build" / "probe"
SHAPES = {"search [64,757,16]": (64, 757, 16),
          "100 M table [256,18925,16]": (256, 18925, 16)}
CALLS = 50

GROUPS = "for (int g = 0; g < nq; g += QI) {"
STORE = "store(out, acc, Q, L, q0 + g, l0, T, scale);"
ELEMENT = "fmaxf(fmaxf(__fsub_rn(lo, qh), __fsub_rn(ql, hi)), 0.f)"
QI = "constexpr int QI = 4;"
R = "constexpr int R = 1;"
QPB = "constexpr int QPB_MAX = 64;"
BOUNDS = "__launch_bounds__(64, 8)"
THREADS = "int T = 64, qpb = QI;"
STEP = "return __fadd_rn(acc, __fmul_rn(d, d));"
ROW_OFFSET = "(size_t)(q0 + i) * L + l"
ROW_STORE = "out[(size_t)(q0 + i) * L + l] = __fmul_rn(scale, acc[i][r]);"
STREAM_STORE = ("__stcs(out + (size_t)(q0 + i) * L + l, "
                "__fmul_rn(scale, acc[i][r]));")


def variants(src: str) -> tuple[dict[str, str], set[str]]:
    """The probe's sources, and the names of those that must give the
    kernel's values."""
    for cut in (GROUPS, STORE, ELEMENT, QI, R, QPB, BOUNDS, THREADS,
                ROW_STORE, STEP):
        if cut not in src:
            sys.exit(f"probe: {cut!r} not found in {SRC}; update the probe")
    out = {"kernel": src,
           "no_math": src.replace(GROUPS, GROUPS.replace("g < nq", "g < 0")),
           "no_store": src.replace(STORE, "if (scale < 0.f) " + STORE),
           "math_only": src.replace(STORE, (
               "{ float s_ = 0.f; for (int i_ = 0; i_ < QI; ++i_) "
               "for (int r_ = 0; r_ < R; ++r_) s_ += acc[i_][r_]; "
               "if (s_ == -1.f) " + STORE + " }")),
           "aligned_rows": src.replace(ROW_OFFSET,
                                       "(size_t)(q0 + i) * ((L + 31) & ~31) + l"),
           "stream": src.replace(ROW_STORE, STREAM_STORE),
           "five": src.replace(
               ELEMENT, "fmaxf(__fsub_rn(lo, qh), __fsub_rn(ql, hi))"),
           "fma": src.replace(STEP, "return fmaf(d, d, acc);"),
           "one_sub": src.replace(
               ELEMENT, "fmaxf(fmaxf(__fsub_rn(lo, qh), ql), 0.f)"),
           "r2": src.replace(R, "constexpr int R = 2;"),
           "lb64": src.replace(BOUNDS, "__launch_bounds__(64, 16)"),
           "qi2": src.replace(QI, "constexpr int QI = 2;"),
           "qi8": src.replace(QI, "constexpr int QI = 8;"),
           "t128": src.replace(BOUNDS, "__launch_bounds__(128, 4)").replace(
               THREADS, "int T = 128, qpb = QI;"),
           "qpb16": src.replace(QPB, "constexpr int QPB_MAX = 16;"),
           "qpb128": src.replace(QPB, "constexpr int QPB_MAX = 128;")}
    return out, set(out) - {"no_math", "no_store", "five", "math_only",
                            "aligned_rows", "fma", "one_sub"}


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT / f"lbpaa_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-shared", str(cu), "-o",
             str(OUT / f"liblbpaa_{name}.so")], stdout=subprocess.PIPE,
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
        lib = ctypes.CDLL(str(OUT / f"liblbpaa_{name}.so"))
        lib.dumpy_lb_paa_interval_f32.argtypes = \
            _build._SIGNATURES["dumpy_lb_paa_interval_f32"]
        libs[name] = lib
    return libs


def sass_counts(name: str) -> None:
    """Opcode counts of the w = 16 instance of ``name``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(OUT / f"liblbpaa_{name}.so")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        print(f"  {name}: cuobjdump failed: {res.stderr.strip()[:200]}")
        return
    funcs = [f for f in res.stdout.split("Function :")[1:]
             if "lb_paa_interval_kernelILi16E" in f.split("\n", 1)[0]]
    if not funcs:
        print(f"  {name}: the w = 16 instance is not in the SASS")
        return
    ops = collections.Counter(
        m.group(1).split(".")[0] for m in
        re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)",
                    funcs[0]))
    print(f"  {name}: {sum(ops.values())} SASS instructions; "
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
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import nvidia_smi, time_ms
    from repro_torch.kernels.ref import lb_paa_interval_in_order
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

    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for label, (Q, L, w) in SHAPES.items():
        sl = torch.randn(Q, w, generator=gen, device="cuda")
        sh = sl + torch.randn(Q, w, generator=gen, device="cuda").abs()
        lo = torch.randn(L, w, generator=gen, device="cuda")
        hi = lo + torch.randn(L, w, generator=gen, device="cuda").abs()
        lo[-1], hi[-1] = float("inf"), float("inf")
        # room for the aligned_rows variant's padded row stride
        out = torch.empty(Q * ((L + 31) & ~31), device="cuda")
        data[label] = (sl, sh, lo, hi, out[:Q * L].view(Q, L))

    def call(lib):
        def run(sl, sh, lo, hi, out):
            Q, w = sl.shape
            err = lib.dumpy_lb_paa_interval_f32(
                sl.data_ptr(), sh.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                out.data_ptr(), Q, lo.shape[0], w, float(256 / w),
                torch.cuda.current_stream().cuda_stream)
            if err:
                sys.exit(f"probe: launch failed with error {err}")
        return run

    for label, a in data.items():
        want = lb_paa_interval_in_order(*a[:4], 256)
        for name in sorted(exact & set(libs)):
            call(libs[name])(*a)
            torch.cuda.synchronize()
            if not torch.equal(a[4], want):
                sys.exit(f"probe: {name} differs from the in-order loop at "
                         f"{label}")
        print(f"  {label}: {sorted(exact & set(libs))} bitwise equal to "
              f"the in-order loop")

    for label, a in data.items():
        times = {name: [] for name in libs}
        for rnd in range(4):
            order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
            for name in order:
                times[name].append(
                    time_ms(torch, call(libs[name]), [a] * CALLS)[0])
        print(f"  {label}, ms per call (events, 4 rounds):")
        for name, ts in times.items():
            print(f"    {name:10s} " + " ".join(f"{t:.5f}" for t in ts)
                  + f"; min {min(ts):.5f}")
    # the SM clock while the kernel runs back to back for about a second
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader", "-lms", "100"], stdout=subprocess.PIPE,
        text=True)
    run, big = call(libs["kernel"]), data["100 M table [256,18925,16]"]
    for _ in range(40_000):
        run(*big)
    torch.cuda.synchronize()
    smi.terminate()
    seen = smi.communicate()[0].strip().splitlines()
    print(f"  clocks.sm, clocks.max.sm, power.draw during 40 000 calls: "
          f"{seen[len(seen) // 2] if seen else 'none read'} "
          f"({len(seen)} readings)")
    from torch.profiler import ProfilerActivity, profile
    big = data["100 M table [256,18925,16]"]
    for name, lib in libs.items():
        run = call(lib)
        run(*big)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                run(*big)
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if "lb_paa_interval" in e.key and "kernel" in e.key]
        kern = (sum(e.self_device_time_total for e in hits)
                / max(sum(e.count for e in hits), 1) / 1e3)
        print(f"  {name:10s} [256,18925,16], kernel alone (profiler) "
              f"{kern:.5f} ms")
    print(f"card: {nvidia_smi()}")


if __name__ == "__main__":
    main()
