"""Device meshes (port of the parts of ``repro.distributed.sharding`` that
``core.distributed`` uses: ``make_mesh``, the current mesh and a context
manager that sets it).

A :class:`Mesh` is one ``"data"`` axis of ``torch.device`` entries: shard
``s`` of a sharded :class:`~repro_torch.core.device_index.DeviceIndex`
lives on ``mesh.devices[s]``.  A device may repeat, so ``[cuda:0] * 4`` is
four shards on one card, and ``[cuda:0, cpu]`` puts two shards on two
devices on a one-card machine.  One process drives every device, as
GSPMD's single controller does in the reference: there is no process
group.

The reference's logical-axis rules for model tensors (``DEFAULT_RULES``,
``logical_spec``) serve its LM substrate, which the port does not have yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of one ``"data"`` axis, in shard order."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """Each device once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))


def _canonical(device) -> torch.device:
    """A mesh entry as a concrete device: ``"cuda"`` becomes ``cuda:<the
    current device>``, so ``"cuda"`` and ``"cuda:0"`` name one device.
    Raises where CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: a mesh of CUDA devices needs a GPU; "
                "build a mesh of 'cpu' entries to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(devices) -> Mesh:
    """A one-axis (``"data"``) mesh over ``devices`` (``torch.device`` or
    strings; repeats allowed)."""
    devices = tuple(_canonical(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh needs at least one device")
    return Mesh(devices)


def get_mesh() -> Mesh | None:
    """The mesh set by the innermost :func:`use_mesh` of this thread."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Make ``mesh`` the current mesh of this thread for the block."""
    prev = get_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev
