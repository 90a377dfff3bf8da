"""Device meshes for the entry points (port of ``repro.launch.mesh``).

Functions, not module-level state, so importing touches no device.  The
entry points' mesh is ``repro_torch.distributed.sharding``'s one-axis
:class:`Mesh` of real devices; :func:`production_device_mesh` is the
reference's named production mesh as a ``DeviceMesh`` over the ranks of a
process group (the dry run's ``"fake"`` group, ``sharding.fake_world``).
"""
from __future__ import annotations

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
