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

The naming half of the reference's logical-axis rules for model tensors
(``DEFAULT_RULES``, ``logical_rules``, ``logical_spec`` and ``shard``)
serves the LM substrate (``repro_torch.models``): model code calls
``shard`` where the reference does.  A rules mesh here is a tuple of axis
names.  Placing model tensors on such a mesh is not ported yet, so
``shard`` is the identity without rules and raises under rules and a mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

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


# ---------------------------------------------------------------------------
# logical-axis rules for model tensors (names only)
# ---------------------------------------------------------------------------

DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_seq": "model",             # inter-layer carry SP (used when
                                    # ArchConfig.act_shard == 'seq')
    "embed": None,
    "embed_fsdp": ("pod", "data"),    # parameter FSDP shard axis
    "heads": "model",
    "kv": None,                       # kv heads often < model size → replicate
    "q_per_kv": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": None,
    "cache_seq": "model",
    "state": "model",                 # recurrent-state feature axis
    "conv": None,
    "layers": None,
    "frames": None,
    "patches": None,
}


def get_rules() -> tuple[tuple[str, ...] | None, dict[str, Any] | None]:
    """The (mesh axis names, rules) set by the innermost
    :func:`logical_rules` of this thread."""
    return (getattr(_state, "rule_axes", None),
            getattr(_state, "rules", None))


@contextlib.contextmanager
def logical_rules(axis_names, rules: dict[str, Any] | None = DEFAULT_RULES):
    """Resolve logical names against a mesh of ``axis_names`` (a tuple of
    names, or ``None`` for no mesh) under ``rules`` for the block."""
    prev = get_rules()
    _state.rule_axes = None if axis_names is None else tuple(axis_names)
    _state.rules = dict(rules) if rules else None
    try:
        yield
    finally:
        _state.rule_axes, _state.rules = prev


def _resolve(names: tuple[str | None, ...], rules: dict[str, Any],
             axis_names: tuple[str, ...]) -> tuple:
    used: set[str] = set()
    out = []
    for nm in names:
        axes = rules.get(nm) if nm else None
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        # drop axes missing from the mesh or already used (a mesh axis may
        # shard only one tensor dim), keep the rest
        keep = tuple(a for a in axes if a in axis_names and a not in used)
        used.update(keep)
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(keep)
    return tuple(out)


def logical_spec(names: tuple[str | None, ...]) -> tuple:
    """Logical names resolved to mesh axes (a ``PartitionSpec``'s entries)
    under the active rules; ``()`` without a mesh or rules."""
    axis_names, rules = get_rules()
    if axis_names is None or rules is None:
        return ()
    return _resolve(tuple(names), rules, axis_names)


def shard(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """Annotate a model tensor with logical axes: ``x`` itself without a
    mesh or rules.  Under both it raises, because placing model tensors
    on a mesh is not ported yet (ROADMAP A15d)."""
    axis_names, rules = get_rules()
    if axis_names is None or rules is None:
        return x
    raise NotImplementedError(
        f"shard{names}: placing model tensors on a mesh "
        f"{axis_names} is not ported yet (ROADMAP A15d)")
