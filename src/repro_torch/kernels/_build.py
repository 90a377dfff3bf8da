"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  On first use they are
compiled for Hopper with ``nvcc -gencode arch=compute_90a,code=sm_90a``, one
``nvcc`` process per source, all started together, then linked into one
shared library under ``build/kernels/`` at the repository root and loaded
with ``ctypes``.  The library's name carries a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads straight
away.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("sax_encode.cu", "pairwise_l2.cu", "lb_paa_interval.cu",
           "lb_keogh.cu", "lb_improved.cu", "dtw_band.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
#: C entry → argtypes; every entry returns ``cudaGetLastError()`` as int
_SIGNATURES = {
    "dumpy_sax_encode_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "dumpy_pairwise_l2_f32": [_P, _P, _P, _I, _I, _I, _P],
    "dumpy_pairwise_l2_smem_bytes": [],
    "dumpy_lb_paa_interval_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "dumpy_lb_keogh_f32": [_P, _P, _P, _P, _I, _I, _I, _LL, _P],
    "dumpy_lb_keogh_smem_bytes": [_I],
    "dumpy_lb_improved_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _P],
    "dumpy_dtw_band_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL,
                           _P],
    "dumpy_dtw_band_scratch_floats": [_I, _I, _I, _I,
                                      ctypes.POINTER(_LL)],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of repro_torch build only where the CUDA "
                           "toolkit is installed")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libdumpy_kernels_{_digest()}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels unless the library for these sources exists.
    Returns ``(library path, compiler log)``; the log holds ``ptxas``'s
    register and shared-memory report (empty when nothing was built)."""
    so = library_path()
    if so.exists():
        return so, ""
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"tmp-{so.stem}-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        obj = tmp / (name + ".o")
        cmd = [nvcc, *FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    part = tmp / so.name
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(part), *(str(obj) for _, obj, _ in procs)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(part, so)            # atomic: a concurrent loader sees all or nothing
    shutil.rmtree(tmp, ignore_errors=True)
    return so, "\n".join(log)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so, _ = build()
            handle = ctypes.CDLL(str(so))
            for fn, argtypes in _SIGNATURES.items():
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = ctypes.c_int
            _lib = handle
    return _lib


def require_cuda(what: str, **tensors) -> None:
    """Check a kernel's float32 operands: ``name=(tensor, ndim or tuple of
    allowed ndims)``; every tensor must be contiguous, on one CUDA
    device."""
    dev = None
    for name, (t, dims) in tensors.items():
        if not t.is_cuda or (dev is not None and t.device != dev):
            raise ValueError(f"{what} kernel takes CUDA tensors on one "
                             f"device")
        dev = t.device
        dims = dims if isinstance(dims, tuple) else (dims,)
        if (t.dtype != torch.float32 or t.dim() not in dims
                or not t.is_contiguous()):
            raise ValueError(
                f"{what}: {name} must be contiguous "
                f"{' or '.join(map(str, dims))}-D float32, got "
                f"{tuple(t.shape)} {t.dtype}")


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def abstract_outputs(what: str, inputs, specs) -> list[torch.Tensor]:
    """Empty outputs of ``specs`` (``(shape, dtype)`` pairs) for a kernel's
    ``abstract`` function, made in the fake mode of its inputs on their
    device.  Every tensor input must be a fake tensor (the dry run's): a
    real tensor raises, since only the kernel computes its result."""
    from torch._subclasses.fake_tensor import FakeTensor
    tensors = [t for t in inputs if isinstance(t, torch.Tensor)]
    for t in tensors:
        if not isinstance(t, FakeTensor):
            raise TypeError(
                f"{what}.abstract takes fake tensors (the dry run's); a real "
                f"tensor goes to the kernel through kernels.ops")
    with tensors[0].fake_mode:
        return [torch.empty(shape, dtype=dt, device=tensors[0].device)
                for shape, dt in specs]


def record(name: str, flops: float, nbytes: float, outputs) -> None:
    """One abstract kernel call's work, for the running dry run."""
    from ..distributed import op_cost
    op_cost.record_kernel(name, flops, nbytes, outputs)
