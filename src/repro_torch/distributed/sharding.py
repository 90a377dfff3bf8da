"""Device meshes and the placement of model tensors on them (port of
``repro.distributed.sharding``).

A :class:`Mesh` is one ``"data"`` axis of ``torch.device`` entries: shard
``s`` of a sharded :class:`~repro_torch.core.device_index.DeviceIndex`
lives on ``mesh.devices[s]``.  A device may repeat, so ``[cuda:0] * 4`` is
four shards on one card, and ``[cuda:0, cpu]`` puts two shards on two
devices on a one-card machine.  One process drives every device, as
GSPMD's single controller does in the reference: there is no process
group.

Model tensors follow the reference's logical-axis rules
(``DEFAULT_RULES``): model code names each tensor dimension and calls
``shard`` where the reference does, and ``logical_rules`` maps the names
to mesh axes for a block.  The mesh there is either a tuple of axis names
(names only: ``logical_spec`` resolves them, and ``shard`` raises, since
there is nothing to place on) or a named
``torch.distributed.device_mesh.DeviceMesh`` (:func:`named_mesh`), on
which the placement half runs: ``named_sharding`` / ``tree_shardings`` /
``shardings_for`` give DTensor placements (``Shard(dim)`` on each mesh
dimension that the resolved spec gives a tensor dimension, ``Replicate()``
elsewhere; ``shardings_for`` replicates a dimension its mesh axes do not
divide, as the reference does for whisper's 51 865-entry vocabulary),
``shard`` redistributes a DTensor to its names' placements (the
reference's ``with_sharding_constraint``), and :func:`local` runs a
function on each device's local shards (the ops DTensor has no sharding
strategy for).  The dry run (``repro_torch.launch.dryrun``) builds such a
mesh over the ``"fake"`` process group (:func:`fake_world`), whose world
size is the mesh's size, and places fake tensors on it; training
(``repro_torch.launch.train`` under ``torchrun``) builds it over the real
ranks of a gloo or NCCL group, one rank per device, where :func:`place`
keeps each rank's own shard of a tensor every rank holds whole.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import types
from typing import Any

import torch
from torch.utils._pytree import tree_flatten, tree_map

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
    Raises where CUDA is asked for and absent, and for a card this machine
    does not have: an entry never falls back to another device."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: a mesh of CUDA devices needs a GPU; "
                "build a mesh of 'cpu' entries to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        elif device.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"mesh entry {device} names an absent card: this machine "
                f"has {torch.cuda.device_count()} CUDA device(s)")
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


#: the rules of the innermost :func:`logical_rules`: process-wide, not a
#: thread's, since autograd runs a CUDA backward (and the recomputation of
#: a checkpointed unit in it) on its own device threads, which must
#: resolve names as the forward did
_rules = types.SimpleNamespace(rule_axes=None, rules=None, device_mesh=None)


def get_rules() -> tuple[tuple[str, ...] | None, dict[str, Any] | None]:
    """The (mesh axis names, rules) set by the innermost
    :func:`logical_rules`."""
    return _rules.rule_axes, _rules.rules


def get_device_mesh():
    """The ``DeviceMesh`` of the innermost :func:`logical_rules`, or
    ``None`` (no rules, or rules over axis names only)."""
    return _rules.device_mesh


def _is_device_mesh(mesh) -> bool:
    return type(mesh).__name__ == "DeviceMesh"


@contextlib.contextmanager
def logical_rules(mesh, rules: dict[str, Any] | None = DEFAULT_RULES):
    """Resolve logical names against ``mesh`` under ``rules`` for the block:
    a named ``DeviceMesh`` (placements and ``shard`` act on it), a tuple of
    axis names (names only), or ``None`` (no mesh)."""
    prev = (get_rules(), get_device_mesh())
    dmesh = mesh if _is_device_mesh(mesh) else None
    names = mesh.mesh_dim_names if dmesh is not None else mesh
    _rules.rule_axes = None if names is None else tuple(names)
    _rules.rules = dict(rules) if rules else None
    _rules.device_mesh = dmesh
    try:
        yield
    finally:
        (_rules.rule_axes, _rules.rules), _rules.device_mesh = prev


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


# ---------------------------------------------------------------------------
# placement on a named DeviceMesh
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(size: int):
    """A ``"fake"`` process group of ``size`` ranks (this process rank 0)
    for the block: collectives are traced, never sent.  Destroyed on
    exit; raises if a process group already exists."""
    import torch.distributed as dist
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(size))
    try:
        yield
    finally:
        dist.destroy_process_group()


def named_mesh(shape, axis_names, device: str | torch.device = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with the reference's axis names (for
    example ``(16, 16)``, ``("data", "model")``) over the ranks of the
    current process group, whose size must be ``prod(shape)``.  Its
    device type is ``device``'s (CUDA unless the caller asks for the CPU;
    raises without CUDA)."""
    from torch.distributed.device_mesh import DeviceMesh

    from ..core.device_index import resolve_device
    device = resolve_device(device)
    n = math.prod(shape)
    return DeviceMesh(device.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _spec_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def divisible_spec(spec: tuple, shape, sizes: dict[str, int]) -> tuple:
    """``spec`` with each tensor dimension that its mesh axes do not divide
    (or that ``shape`` lacks) replicated: ``shardings_for``'s fallback."""
    fixed = []
    for i, ax in enumerate(spec):
        axes = _spec_axes(ax)
        size = math.prod(sizes[a] for a in axes)
        fixed.append(ax if axes and i < len(shape) and shape[i] % size == 0
                     else None)
    return tuple(fixed)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a resolved spec on ``mesh``: ``Shard(i)`` on
    each mesh dimension that ``spec[i]`` names, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for i, ax in enumerate(spec):
        for a in _spec_axes(ax):
            out[names.index(a)] = Shard(i)
    return tuple(out)


def spec_of(placements_, mesh, ndim: int) -> tuple:
    """The spec a tuple of placements stands for (the inverse of
    :func:`placements`): per tensor dimension the mesh axes sharding it,
    in mesh order (a name, a tuple of names, or ``None``)."""
    out: list = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, placements_):
        if p.is_shard():
            out[p.dim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in out)


def _active():
    mesh, (axis_names, rules) = get_device_mesh(), get_rules()
    if mesh is None or rules is None:
        return None, None
    return mesh, rules


def named_sharding(names: tuple[str | None, ...]):
    """The placements of a tensor with logical ``names`` under the active
    rules and ``DeviceMesh`` (``None`` without them)."""
    mesh, rules = _active()
    if mesh is None:
        return None
    return placements(_resolve(tuple(names), rules, mesh.mesh_dim_names),
                      mesh)


def _is_names(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(i, (str, type(None)))
                                        for i in x)


def _map_names(fn, tree, *rest):
    """``fn`` over the name-tuple leaves of a tree of dicts and lists (and
    the matching leaves of ``rest``)."""
    if _is_names(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_names(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_names(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a tree of logical names: {tree!r}")


def tree_shardings(logical_tree: Any) -> Any:
    """A tree of logical-name tuples → a tree of placements (the dry run's
    ``in_shardings``)."""
    mesh, rules = _active()
    assert mesh is not None and rules is not None
    return _map_names(lambda names: named_sharding(names), logical_tree)


def shardings_for(abstract_tree: Any, logical_tree: Any) -> Any:
    """Like :func:`tree_shardings`, checked against the tensors (or shapes)
    of ``abstract_tree``: mesh axes whose size does not divide a dimension
    are dropped for that dimension."""
    mesh, rules = _active()
    assert mesh is not None and rules is not None
    sizes = _axis_sizes(mesh)

    def leaf(names, abs_leaf):
        spec = _resolve(tuple(names), rules, mesh.mesh_dim_names)
        return placements(divisible_spec(spec, tuple(abs_leaf.shape), sizes),
                          mesh)

    return _map_names(leaf, logical_tree, abstract_tree)


def divisible(dim: int, names: tuple[str | None, ...], axis_index: int
              ) -> bool:
    """Whether ``dim`` divides the mesh axes that ``names[axis_index]``
    maps to (``True`` without rules and a mesh)."""
    axis_names, rules = get_rules()
    mesh = get_device_mesh()
    if axis_names is None or rules is None or mesh is None:
        return True
    spec = _resolve(tuple(names), rules, axis_names)
    axes = _spec_axes(spec[axis_index] if axis_index < len(spec) else None)
    return dim % math.prod(_axis_sizes(mesh)[a] for a in axes) == 0


def local_shape(shape, placements_, mesh) -> tuple[int, ...]:
    """The shape of one device's shard of a tensor of global ``shape``
    (even shards)."""
    out = list(shape)
    for p, size in zip(placements_, mesh.shape):
        if p.is_shard():
            out[p.dim] //= size
    return tuple(out)


def place(x: torch.Tensor, placements_, mesh, *, local: bool = False):
    """A DTensor of ``placements_`` on ``mesh``: from ``x``, the global
    tensor, which every rank holds whole (each rank keeps its own shard,
    cut here, on the mesh's device: no collective), or with ``local``, one
    device's shard itself (fake tensors of the dry run: nothing is cut)."""
    from torch.distributed.tensor import DTensor
    if not local:
        x = local_chunk(x, placements_, mesh)
        dev = torch.device(mesh.device_type)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        x = torch.empty(x.shape, dtype=x.dtype, device=dev).copy_(x)
    return DTensor.from_local(x, mesh, placements_, run_check=False)


def local_chunk(x: torch.Tensor, placements_, mesh) -> torch.Tensor:
    """This rank's shard of the global tensor ``x`` (a view): along each
    mesh dimension that shards a tensor dimension, the chunk of this
    rank's coordinate, mesh dimensions in order (DTensor's even
    chunking)."""
    coord = mesh.get_coordinate()
    for md, p in enumerate(placements_):
        if p.is_shard():
            x = torch.chunk(x, mesh.shape[md], dim=p.dim)[coord[md]]
    return x


def counted_here(x) -> bool:
    """Whether this rank's shard of ``x`` is the one a sum over every
    rank counts: a plain tensor always; a DTensor where this rank's
    coordinate is 0 along each mesh dimension that does not shard it (the
    other ranks there hold copies)."""
    if not is_dtensor(x):
        return True
    coord = x.device_mesh.get_coordinate()
    return all(p.is_shard() or c == 0 for p, c in zip(x.placements, coord))


def place_rows(x: torch.Tensor, names, mesh, host: int = 0,
               hosts: int = 1):
    """A DTensor of the global batch whose host ``host`` of ``hosts``
    holds the rows ``x`` (``repro_torch.data.tokens``' slice), placed by
    the logical ``names`` under the active rules: each rank keeps its own
    rows of ``x``, which must lie in its host's slice."""
    from torch.distributed.tensor import DTensor, Replicate
    gshape = (x.shape[0] * hosts,) + tuple(x.shape[1:])
    pl = _fixed_placements(gshape, names)
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for md, p in enumerate(pl):
        if p.is_shard() and p.dim == 0:
            idx, n = idx * mesh.shape[md] + coord[md], n * mesh.shape[md]
    per = gshape[0] // n
    lo = idx * per - host * x.shape[0]
    if not 0 <= lo <= x.shape[0] - per:
        raise ValueError(
            f"this rank's rows {idx * per}:{(idx + 1) * per} of the global "
            f"batch lie outside its host's {host * x.shape[0]}:"
            f"{(host + 1) * x.shape[0]}")
    rest = [Replicate() if p.is_shard() and p.dim == 0 else p for p in pl]
    return DTensor.from_local(local_chunk(x[lo:lo + per], rest, mesh),
                              mesh, pl, run_check=False)


def is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a collective over its mesh); a plain
    tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def rank_and_size() -> tuple[int, int]:
    """This process's rank and the world size of the initialised process
    group, or (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """Annotate a model tensor with logical axes: ``x`` itself without a
    mesh or rules, and for a tensor that is not a DTensor.  Under rules and
    a ``DeviceMesh`` a DTensor is redistributed to its names' placements
    (axes that do not divide a dimension dropped), as the reference's
    ``with_sharding_constraint``.  Under rules over axis names alone it
    raises: names resolve to a spec there, but a tensor can only be placed
    on the ranks of a ``DeviceMesh`` (:func:`named_mesh`)."""
    axis_names, rules = get_rules()
    if axis_names is None or rules is None:
        return x
    mesh = get_device_mesh()
    if mesh is None:
        raise NotImplementedError(
            f"shard{names}: the rules are over the axis names {axis_names} "
            f"alone; placing a model tensor needs a DeviceMesh of ranks "
            f"(named_mesh, under logical_rules)")
    if not is_dtensor(x):
        return x
    return x.redistribute(mesh, _fixed_placements(x.shape, names))


def like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` redistributed to ``ref``'s placements where both are DTensors
    (a branch's output before it joins a residual stream placed otherwise,
    so the gradient comes back in the branch's own placement); ``x``
    itself otherwise."""
    if is_dtensor(x) and is_dtensor(ref) and \
            tuple(x.placements) != tuple(ref.placements):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def batch_rows(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows ``lo:hi`` of ``x``'s leading (batch) dimension.  Of a DTensor
    sharded along it, the same share of each device's own rows, so a
    microbatch stays sharded as its batch was (which rows form it differs;
    their number and placement do not)."""
    if not is_dtensor(x):
        return x[lo:hi]
    n = math.prod(size for p, size in zip(x.placements, x.device_mesh.shape)
                  if p.is_shard() and p.dim == 0)
    if n == 1:
        return x[lo:hi]
    from torch.distributed.tensor import DTensor
    loc = x.to_local()[lo // n:hi // n]
    return DTensor.from_local(loc, x.device_mesh, x.placements,
                              run_check=False)


def _fixed_placements(shape, names) -> tuple:
    mesh, rules = _active()
    spec = _resolve(tuple(names), rules, mesh.mesh_dim_names)
    return placements(divisible_spec(spec, tuple(shape), _axis_sizes(mesh)),
                      mesh)


def local(fn, in_names, out_names):
    """``fn`` run on each device's local shards: without rules and a
    ``DeviceMesh``, ``fn`` itself.  Under them, the DTensor arguments are
    redistributed to the placements of ``in_names`` (one name tuple per
    positional argument, ``None`` for an argument passed as it is), ``fn``
    runs on their local tensors, and each output becomes a DTensor of
    ``out_names`` (one tuple per output; a tuple of names for one output).
    The counterpart of ``local_map`` for the ops DTensor has no sharding
    strategy for; a dimension sharded here is one ``fn`` treats
    independently."""
    def wrapped(*args, **kwargs):
        mesh, rules = _active()
        if mesh is None or not any(is_dtensor(a) for a in args):
            return fn(*args, **kwargs)
        loc, kept = [], {}
        for a, names in zip(args, in_names):
            if names is not None and is_dtensor(a):
                pl = _fixed_placements(a.shape, names)
                a = a.redistribute(mesh, pl)
                # a name replicated on one input (its axes do not divide
                # the dimension) stays replicated on the outputs
                for nm, ax in zip(names, spec_of(pl, mesh, len(names))):
                    if nm is not None:
                        kept[nm] = kept.get(nm, True) and ax is not None
            loc.append(a.to_local() if is_dtensor(a) else a)
        out = fn(*loc, **kwargs)
        single = _is_names(out_names)
        outs = (out,) if single else tuple(out)
        names_out = (out_names,) if single else tuple(out_names)
        res = []
        for o, names in zip(outs, names_out):
            if names is None or not isinstance(o, torch.Tensor):
                res.append(o)
                continue
            names = tuple(nm if kept.get(nm, True) else None
                          for nm in names)
            spec = _resolve(names, rules, mesh.mesh_dim_names)
            gshape = list(o.shape)
            for i, ax in enumerate(spec):
                for a in _spec_axes(ax):
                    gshape[i] *= _axis_sizes(mesh)[a]
            pl = placements(divisible_spec(spec, tuple(gshape),
                                           _axis_sizes(mesh)), mesh)
            res.append(place(o, pl, mesh, local=True))
        return res[0] if single else type(out)(res)
    return wrapped


def batch_local(fn, batched, module):
    """``fn(batched, module)`` on each device's rows of the batch: without
    rules and a ``DeviceMesh``, that call itself.  Under them, every tensor
    of ``batched`` (a tree whose tensors lead with the batch dimension) is
    redistributed to batch-sharded, ``module``'s parameters are gathered
    whole (replicated) and passed as attributes of a namespace, ``fn`` runs
    on the local tensors, and every tensor of its output tree comes back
    batch-sharded.  For blocks whose ops DTensor has no sharding strategy
    for (the recurrent cells): each device computes its batch rows in
    full, which the per-device count shows."""
    mesh, rules = _active()
    if mesh is None or not any(is_dtensor(t) for t in
                               tree_flatten(batched)[0]):
        return fn(batched, module)
    import types

    from torch.distributed.tensor import Replicate

    def to_local(t, names):
        if not is_dtensor(t):
            return t
        pl = (_fixed_placements(t.shape, names) if names is not None
              else (Replicate(),) * mesh.ndim)
        return t.redistribute(mesh, pl).to_local()

    loc = tree_map(lambda t: to_local(t, ("batch",) + (None,) * (t.ndim - 1))
                   if isinstance(t, torch.Tensor) else t, batched)
    weights = types.SimpleNamespace(**{
        n: to_local(p, None) for n, p in module.named_parameters()})
    sharded = any(p.is_shard() and p.dim == 0 for t in
                  tree_flatten(batched)[0] if is_dtensor(t)
                  for p in _fixed_placements(t.shape, ("batch",)))
    n = math.prod(size for a, size in _axis_sizes(mesh).items()
                  if a in _spec_axes(_resolve(("batch",), rules,
                                              mesh.mesh_dim_names)[0]))

    def back(t):
        if not isinstance(t, torch.Tensor):
            return t
        gshape = (t.shape[0] * (n if sharded else 1),) + tuple(t.shape[1:])
        pl = _fixed_placements(gshape, ("batch",) + (None,) * (t.ndim - 1))
        return place(t, pl, mesh, local=True)
    return tree_map(back, fn(loc, weights))


def write_slot(buf: torch.Tensor, new: torch.Tensor, at: int
               ) -> torch.Tensor:
    """``buf[:, at:at + 1] = new`` in place (a cache write of one position
    along dimension 1).  On a DTensor sharded along that dimension only the
    device holding position ``at`` writes, into its own shard, as the
    reference's compiler does a ``dynamic_update_slice``: no collective."""
    if not is_dtensor(buf):
        buf[:, at:at + 1] = new.to(buf.dtype)
        return buf
    from torch.distributed.tensor import Replicate
    mesh = buf.device_mesh
    pl = tuple(Replicate() if p.is_shard() and p.dim == 1 else p
               for p in buf.placements)
    new_l = new.redistribute(mesh, pl).to_local() if is_dtensor(new) \
        else new
    loc = buf.to_local()
    coord = mesh.get_coordinate()
    idx = 0
    for md, p in enumerate(buf.placements):
        if p.is_shard() and p.dim == 1:
            idx = idx * mesh.shape[md] + coord[md]
    lo = idx * loc.shape[1]
    if lo <= at < lo + loc.shape[1]:
        loc[:, at - lo:at - lo + 1] = new_l.to(loc.dtype)
    return buf
