"""Three-term roofline of a dry-run cell on the NVIDIA H100 SXM (port of
``repro.distributed.roofline``, which models a TPU).

    compute    = Σ_dtype FLOPs[dtype] / PEAK_FLOPS[dtype]
    memory     = HBM bytes           / HBM_BW
    collective = bytes within a host / NVLINK_BW + bytes across hosts / NIC_BW

Every term is one device's (the dry run counts one device's program), and
the step bound is the largest (perfect overlap).  The peaks are NVIDIA's
published dense numbers for the H100 SXM at its 700 W limit (the H100 data
sheet):

* tensor cores: 989 TFLOP/s bf16 and fp16, 495 TF32 (only where the program
  enables TF32), 1979 int8; float32 outside the tensor cores 67 (the
  ``100m`` preset and the reduced models compute in float32, TF32 off);
* HBM3: 3.35 TB/s;
* NVLink 4 inside one 8-card host: 450 GB/s each way a card (H100 data
  sheet, 900 GB/s bidirectional);
* across hosts: one 400 Gb/s InfiniBand NIC a card, 50 GB/s (DGX H100 data
  sheet: eight ConnectX-7 at 400 Gb/s for eight cards).  On the 16×16 and
  2×16×16 meshes every axis spans hosts, so their collectives are charged
  at this rate.

A card set below 700 W runs slower under load: these are bounds, not
measured times.  MODEL_FLOPS uses 6·N·D (train) or 2·N·D (inference) with
N the active parameters and D the tokens of the step; its ratio to the
counted FLOPs flags recomputation (remat) or dispatch waste.
"""
from __future__ import annotations

import dataclasses

#: dense peak operations per second of one card, by the dtype of the operands
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12, "int8": 1979e12, "float64": 67e12}
HBM_BW = 3.35e12           # bytes/s a card
NVLINK_BW = 450e9          # bytes/s a card each way, inside one host
NIC_BW = 50e9              # bytes/s a card across hosts (400 Gb/s)
GPUS_PER_HOST = 8


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_global: float   # counted FLOPs × devices (the reference's name)
    useful_ratio: float
    bottleneck: str
    step_s: float           # max of the three (perfect-overlap bound)
    roofline_fraction: float  # compute_s / step_s (how compute-bound we are)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def compute_seconds(flops_by_dtype: dict) -> float:
    """Σ FLOPs of each dtype over that dtype's peak (an unknown dtype at
    the float32 peak)."""
    return sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
               for dt, f in flops_by_dtype.items())


def analyze(*, flops_per_device: float, bytes_per_device: float,
            collective_bytes_per_device: float, n_devices: int,
            model_flops: float, flops_by_dtype: dict | None = None,
            inter_host_bytes: float | None = None) -> Roofline:
    """The three terms of one device.  ``flops_by_dtype`` splits the FLOPs
    by operand dtype (all bf16 without it); ``inter_host_bytes`` is the
    part of the collective bytes whose groups span hosts (all of them
    without it when the mesh spans hosts, none when it fits one host)."""
    if flops_by_dtype is None:
        flops_by_dtype = {"bfloat16": flops_per_device}
    compute_s = compute_seconds(flops_by_dtype)
    memory_s = bytes_per_device / HBM_BW
    if inter_host_bytes is None:
        inter_host_bytes = (collective_bytes_per_device
                            if n_devices > GPUS_PER_HOST else 0.0)
    intra = collective_bytes_per_device - inter_host_bytes
    collective_s = intra / NVLINK_BW + inter_host_bytes / NIC_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step = max(terms.values())
    hlo_global = flops_per_device * n_devices
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops=model_flops, hlo_flops_global=hlo_global,
        useful_ratio=(model_flops / hlo_global if hlo_global else 0.0),
        bottleneck=bottleneck, step_s=step,
        roofline_fraction=(compute_s / step if step else 0.0))


def kernel_bound_s(flops: float, nbytes: float,
                   dtype: str = "float32") -> tuple[float, str]:
    """One kernel's bound: ``(seconds, "bytes" | "operations")``, the larger
    of its bytes over HBM and its operations over the dtype's peak."""
    t_b = nbytes / HBM_BW
    t_o = flops / PEAK_FLOPS[dtype]
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def model_flops_estimate(n_params_active: float, tokens: float,
                         kind: str) -> float:
    """6·N·D for training, 2·N·D for inference forward (prefill/decode)."""
    if kind == "train":
        return 6.0 * n_params_active * tokens
    return 2.0 * n_params_active * tokens
