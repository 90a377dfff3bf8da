#!/usr/bin/env python3
"""Where the ``pairwise_l2`` kernel's time goes, on one NVIDIA GPU.

    python3 scripts/probe_pairwise_l2.py [--with NAME=path/to/kernel.cu ...]

Builds ``src/repro_torch/kernels/csrc/pairwise_l2.cu`` and three cut-down
copies of it, made by editing its source: ``no_fma`` (copies, barriers and
the epilogue, without the FMA loop), ``no_copy`` (the shared reads and FMAs
on whatever shared memory holds, without the copies) and ``neither`` (the
launch, the barriers, the epilogue and the stores).  The cut-down copies
compute nothing useful: they only split the kernel's time.  ``--with``
adds another source with the same C entry point (an earlier commit's
kernel, say), held against a float64 product like the kernel itself.

Each is timed at the ED slab's shape [64, 2048, 256] on a cold 2048-row
slab per call: CUDA events around 50 calls queued behind a held stream
(``chip_smoke.time_ms``), in four rounds of alternating order, and
``torch.profiler``'s device time of the kernel alone.  The card's name and
power limit are printed first.  Builds go to ``build/probe/``.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "pairwise_l2.cu"
OUT = ROOT / "build" / "probe"
Q, X, N, CALLS = 64, 2048, 256, 50

FMA_LOOP = "for (int g = 0; g < KC / 4 / CLASSES; ++g) {"
COPY = "load_chunk<VEC>(smem"


def variants(src: str) -> dict[str, str]:
    for cut in (FMA_LOOP, COPY):
        if cut not in src:
            sys.exit(f"probe: {cut!r} not found in {SRC}; update the probe")
    no_fma = src.replace(FMA_LOOP, "for (int g = 0; g < 0; ++g) {")
    return {"kernel": src, "no_fma": no_fma,
            "no_copy": src.replace(COPY, "if (false) " + COPY),
            "neither": no_fma.replace(COPY, "if (false) " + COPY)}


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
        lib.dumpy_pairwise_l2_f32.argtypes = \
            _build._SIGNATURES["dumpy_pairwise_l2_f32"]
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--with", dest="extra", action="append", default=[],
                    metavar="NAME=PATH", help="another kernel source")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("probe: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import nvidia_smi, time_ms
    print(f"card: {nvidia_smi()}")
    sources = variants(SRC.read_text())
    for item in args.extra:
        name, path = item.split("=", 1)
        sources[name] = Path(path).read_text()
    libs = build(sources)

    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(Q, N, generator=gen, device="cuda")
    db = torch.randn(CALLS * X, N, generator=gen, device="cuda")
    out = torch.empty(Q, X, device="cuda")

    def call(lib):
        def run(x):
            err = lib.dumpy_pairwise_l2_f32(
                q.data_ptr(), x.data_ptr(), out.data_ptr(), Q, X, N,
                torch.cuda.current_stream().cuda_stream)
            if err:
                sys.exit(f"probe: launch failed with error {err}")
        return run

    slabs = [(db[i * X:(i + 1) * X],) for i in range(CALLS)]
    want = (q.double()[:, None] - db[:X].double()[None]).pow(2).sum(-1)
    scale = (q.double().pow(2).sum(1)[:, None]
             + db[:X].double().pow(2).sum(1)[None])
    for name in ["kernel", *(n for n in sources if n not in
                             ("kernel", "no_fma", "no_copy", "neither"))]:
        call(libs[name])(db[:X])
        torch.cuda.synchronize()
        rel = float(((out.double() - want).abs() / scale).max())
        print(f"  {name}: max |err| / (|q|^2 + |x|^2) against float64 "
              f"{rel:.3e}")
        if rel > 1e-5:
            sys.exit(f"probe: {name} is wrong")

    times = {name: [] for name in libs}
    for rnd in range(4):
        order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
        for name in order:
            times[name].append(time_ms(torch, call(libs[name]), slabs)[0])
    from torch.profiler import ProfilerActivity, profile
    for name, lib in libs.items():
        run = call(lib)
        for a in slabs[:3]:
            run(*a)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for a in slabs:
                run(*a)
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if "pairwise_l2_kernel" in e.key]
        kern = (sum(e.self_device_time_total for e in hits)
                / max(sum(e.count for e in hits), 1) / 1e3)
        print(f"  {name:10s} ms per call (events, 4 rounds): "
              + " ".join(f"{t:.5f}" for t in times[name])
              + f"; min {min(times[name]):.5f}; kernel alone (profiler) "
              f"{kern:.5f} ms")
    print(f"card: {nvidia_smi()}")


if __name__ == "__main__":
    main()
