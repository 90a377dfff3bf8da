"""Device meshes for the entry points (port of ``repro.launch.mesh``).

Functions, not module-level state, so importing touches no device.  The
Dumpy entry points' mesh is ``repro_torch.distributed.sharding``'s
one-axis :class:`Mesh` of real devices, driven by one process.  Training
runs one process per device instead (``torchrun``): :func:`world` starts
or joins that process group from ``torchrun``'s environment, and
:func:`make_rank_mesh` is the reference's host mesh, ``(data, model)``
factored from the device count, as a named ``DeviceMesh`` over its ranks.
:func:`production_device_mesh` is the reference's named production mesh
over the ranks of a process group (the dry run's ``"fake"`` group,
``sharding.fake_world``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import torch

from repro_torch.distributed.sharding import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's 16×16 single pod (256 devices) or 2×16×16 multi-pod
    (512 devices), as one axis over the visible CUDA devices; raises where
    fewer are visible, as the reference's ``make_mesh`` fails."""
    need = 512 if multi_pod else 256
    n = torch.cuda.device_count()
    if n < need:
        raise RuntimeError(
            f"a {'multi-pod' if multi_pod else 'single-pod'} mesh needs "
            f"{need} devices, {n} visible")
    return make_mesh([f"cuda:{i}" for i in range(need)])


#: the reference's production meshes: (shape, axis names) by name
PRODUCTION_MESHES = {
    "pod_16x16": ((16, 16), ("data", "model")),
    "multi_pod_2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def production_device_mesh(*, multi_pod: bool = False,
                           device: str | torch.device = "cuda"):
    """The reference's 16×16 pod (``("data", "model")``) or 2×16×16
    multi-pod (``("pod", "data", "model")``) as a named ``DeviceMesh`` over
    the current process group, which must have 256 or 512 ranks (for the
    dry run, ``sharding.fake_world``).  CUDA unless the caller asks for the
    CPU."""
    from repro_torch.distributed.sharding import named_mesh
    shape, names = PRODUCTION_MESHES["multi_pod_2x16x16" if multi_pod
                                     else "pod_16x16"]
    return named_mesh(shape, names, device)


def make_host_mesh(device: str = "cuda") -> Mesh:
    """Whatever devices exist: every visible CUDA device (raises without
    CUDA), or the CPU alone when ``device`` is ``"cpu"``."""
    if torch.device(device).type == "cpu":
        return make_mesh(["cpu"])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n >= 256:
        return make_production_mesh()
    return make_mesh([f"cuda:{i}" for i in range(n)] or ["cuda"])


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place among the ranks: its rank and their number,
    its device, and whether a process group joins the ranks (``False`` for
    a lone process, which trains on the plain path)."""

    rank: int
    size: int
    device: torch.device
    grouped: bool


@contextlib.contextmanager
def world(device: str | torch.device = "cuda"):
    """This process's :class:`World` for the block.  Under ``torchrun``
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and its
    rendezvous address in the environment) it starts the process group,
    NCCL on ``cuda:LOCAL_RANK`` or gloo when ``device`` is the CPU, and
    destroys it at the end; a group already initialised is joined as it
    is and left standing.  With no such environment it is a world of one
    and starts nothing.  CUDA unless the caller asks for the CPU; raises
    without CUDA."""
    import torch.distributed as dist

    from repro_torch.core.device_index import resolve_device
    dev = resolve_device(device)
    started = False
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        local = int(os.environ.get("LOCAL_RANK", 0))
        if dev.type == "cuda":
            dev = torch.device("cuda", local)
            torch.cuda.set_device(dev)
            dist.init_process_group("nccl", device_id=dev)
        else:
            dist.init_process_group("gloo")
        started = True
    try:
        if not dist.is_initialized():
            yield World(0, 1, dev, False)
            return
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        yield World(dist.get_rank(), dist.get_world_size(), dev, True)
    finally:
        if started:
            dist.destroy_process_group()


def make_rank_mesh(device: str | torch.device = "cuda"):
    """The reference's ``make_host_mesh`` over the ranks of the current
    process group: its 16 x 16 production mesh at 256 ranks or more,
    else ``(n // model, model)`` over ``("data", "model")``, ``model`` the
    largest of 16, 8, 4, 2, 1 that divides ``n``, as a named
    ``DeviceMesh``.  CUDA unless the caller asks for the CPU."""
    import torch.distributed as dist

    from repro_torch.core.device_index import resolve_device
    from repro_torch.distributed.sharding import named_mesh
    device = resolve_device(device)
    n = dist.get_world_size()
    if n >= 256:
        return production_device_mesh(device=device)
    m = next(m for m in (16, 8, 4, 2, 1) if n % m == 0)
    return named_mesh((n // m, m), ("data", "model"), device)
