"""Per-device op cost of a program run on fake tensors (the port's
counterpart of ``repro.distributed.hlo_cost``, which reads a compiled XLA
module).

:func:`analyze` runs a function under ``FakeTensorMode``: every tensor has
a shape, a dtype and a device but no data, so nothing is allocated and a
full-size model runs on any host.  A dispatch mode (a
:class:`~repro_torch.analysis.contracts.Census`, with its kernel swap and
host-sync prediction) sees every aten op that reaches a tensor.  On a
DTensor it returns ``NotImplemented``, so DTensor runs its sharding
propagation and redispatches the ops on each device's local shard, which
the mode then sees: the counts are one device's.  The ops DTensor's
sharding propagation runs at the global shape to learn output metadata are
left out (the propagator runs with the mode suspended).

Counting rules (:class:`OpCost`):

* ``flops`` — ``torch.utils.flop_counter``'s formula of each local op
  (matmuls, convolutions, attention), ``flops_by_dtype`` keyed on the
  first operand's dtype (``"tf32"`` for float32 where the program enables
  TF32); the kernels record their own operation counts;
* ``hbm_bytes`` — operands plus results of the materialising ops only
  (:data:`MATERIALIZING`: matmuls and convolutions, reductions, gathers and
  scatters, sorts, ``cat``, copies, collectives, and the kernels); a gather
  reads and writes its result's bytes, a scatter its update's, as in
  ``hlo_cost``.  Elementwise ops count as fused away;
* ``hbm_bytes_hi`` — every op's operands plus results (views excluded);
* ``collective_bytes`` / ``collective_counts`` — operand bytes of each
  ``_c10d_functional`` collective by kind (``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``), plus those a caller adds with
  :meth:`OpCost.add_collective`;
* ``unknown_loops`` — always 0: an eager program's loops run in Python,
  so every trip is counted, or one trip is and :func:`scaled` multiplies
  its work by the loop's trip count (the counterpart of ``hlo_cost``'s
  ``trips ×`` a ``while`` body), which ``loops`` sums by loop name;
* memory — the live bytes of the local storages, tracked with weakref
  finalizers on the fake storages: ``argument_bytes`` (what the program is
  given), ``output_bytes`` (what it returns, aliased storages included),
  ``alias_bytes`` (returned storages that are arguments: parameters and
  moments updated in place, a cache written in place), ``temp_bytes``, and
  ``peak_bytes = argument + output + temp - alias``, the most live at once,
  as the reference's ``memory_analysis`` splits it.  Each tracked storage
  keeps the aten op that made it (``"argument"`` for the program's own);
  under ``analyze(..., sites=True)`` also the model code that ran the op
  (or the autograd node, in the backward pass), and ``peak_sites`` holds
  the live bytes at the peak grouped by the two, largest first (it is not
  part of a record);
* ``flops_global`` — the unscaled ``FlopCounterMode`` total: the same
  formulas over the DTensor-level ops at their global shapes (the
  counterpart of XLA's raw ``cost_analysis``);
* ``host_syncs`` — the census's predicted host syncs (a data-dependent
  read on fake tensors raises instead).
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
import weakref
from collections import Counter
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..analysis import contracts

#: aten base names whose operands and results move through HBM
MATMULS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "addmv",
                     "mv", "dot", "convolution", "convolution_backward",
                     "_scaled_dot_product_efficient_attention",
                     "_scaled_dot_product_flash_attention",
                     "_scaled_dot_product_cudnn_attention"})
REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "logsumexp", "var",
    "var_mean", "std", "std_mean", "norm", "linalg_vector_norm", "prod",
    "any", "all", "argmax", "argmin", "cumsum", "cumprod", "cummin",
    "cummax", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "nll_loss_forward", "nll_loss_backward",
    "native_layer_norm", "native_layer_norm_backward", "count_nonzero"})
GATHERS = frozenset({"gather", "index", "index_select", "embedding",
                     "take", "_unsafe_index", "embedding_dense_backward"})
SCATTERS = frozenset({"scatter", "scatter_", "scatter_add", "scatter_add_",
                      "scatter_reduce", "scatter_reduce_", "index_add",
                      "index_add_", "index_put", "index_put_",
                      "_index_put_impl_", "index_copy", "index_copy_"})
SORTS = frozenset({"sort", "topk", "argsort", "searchsorted", "_unique2",
                   "unique_dim", "unique_consecutive", "kthvalue", "median"})
MOVES = frozenset({"cat", "stack", "copy_", "clone", "_to_copy",
                   "constant_pad_nd", "flip", "roll", "repeat",
                   "_pad_enum"})
COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "all_gather_into_tensor_out": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "broadcast": "broadcast", "broadcast_": "broadcast"}
MATERIALIZING = (MATMULS | REDUCTIONS | GATHERS | SCATTERS | SORTS | MOVES
                 | frozenset(COLLECTIVES))
#: dtype names of ``flops_by_dtype`` (the roofline's peaks are keyed on
#: them)
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.float32: "float32", torch.float64: "float64",
                torch.int8: "int8", torch.uint8: "int8"}

_active: "_Tracer | None" = None
#: the scalar fields of :class:`OpCost` a loop trip adds to
_SCALED = ("flops", "hbm_bytes", "hbm_bytes_hi", "collective_bytes",
           "inter_host_bytes", "flops_global", "n_ops")


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    hbm_bytes: float = 0.0
    hbm_bytes_hi: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    inter_host_bytes: float = 0.0
    unknown_loops: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    temp_bytes: int = 0
    peak_bytes: int = 0
    flops_global: float = 0.0
    kernels: dict = dataclasses.field(default_factory=dict)
    aten_ops: dict = dataclasses.field(default_factory=dict)
    dtypes: dict = dataclasses.field(default_factory=dict)
    host_syncs: dict = dataclasses.field(default_factory=dict)
    loops: dict = dataclasses.field(default_factory=dict)
    n_ops: int = 0
    seconds: float = 0.0
    peak_sites: list = dataclasses.field(default_factory=list)

    def add_flops(self, flops: float, dtype: str) -> None:
        self.flops += flops
        self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0.0) + \
            flops

    def add_collective(self, kind: str, nbytes: float, count: int = 1, *,
                       inter_host: bool = True) -> None:
        """A collective the program makes outside the traced ops (the
        merge of Dumpy's shard results): ``count`` of ``kind`` moving
        ``nbytes`` in all from this device, over a group that spans hosts
        unless ``inter_host`` is false."""
        self.collective_bytes += nbytes
        self.inter_host_bytes += nbytes if inter_host else 0.0
        self.hbm_bytes += nbytes
        self.hbm_bytes_hi += nbytes
        e = self.collective_counts.setdefault(kind, {"count": 0,
                                                     "bytes": 0.0})
        e["count"] += count
        e["bytes"] += nbytes

    def memory(self) -> dict:
        """The record's ``memory`` field (``memory_analysis``'s split)."""
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes,
                "alias_bytes": self.alias_bytes,
                "peak_per_device": self.peak_bytes}


def _dtype_name(dtype: torch.dtype) -> str:
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return _DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _plain_tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_tensors(tree) -> list[torch.Tensor]:
    """The tensors holding storage in a tree of modules, dicts, lists,
    tuples and DTensors (a DTensor's local shard)."""
    out: list[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.nn.Module):
            for p in x.parameters():
                walk(p)
            for b in x.buffers():
                walk(b)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            loc = getattr(x, "_local_tensor", None)
            out.append(loc if loc is not None else x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
    walk(tree)
    return out


#: files whose frames do not name a site (the counting and placing code)
_NOT_SITES = tuple(os.sep + os.path.join("repro_torch", *p) for p in (
    ("distributed", "op_cost.py"), ("distributed", "sharding.py"),
    ("analysis", "contracts.py")))
_PKG = os.sep + "repro_torch" + os.sep


def _site() -> str:
    """The innermost ``repro_torch`` function running the current op
    (``module.function``), prefixed by the autograd node in the backward
    pass (a recomputed forward names its own function)."""
    node = torch._C._current_autograd_node()
    where = f"{node.name()} " if node is not None else ""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if _PKG in fn and not fn.endswith(_NOT_SITES):
            mod = fn.rsplit(_PKG, 1)[1][:-3].replace(os.sep, ".")
            return f"{where}{mod}.{f.f_code.co_name}"
        f = f.f_back
    return where.strip() or "?"


class _CostMode(TorchDispatchMode):
    def __init__(self, tracer: "_Tracer"):
        super().__init__()
        self.t = tracer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            if not self.t.suspend:
                self.t.count_global(func, args, kwargs)
            return NotImplemented
        if self.t.suspend:
            return func(*args, **kwargs)
        return self.t._on_op(func, args, kwargs)


class _Tracer(contracts.Census):
    """A census (kernel swap, aten histogram, predicted host syncs) that
    also counts cost and live storage bytes; the kernels are swapped for
    their ``abstract`` functions."""

    def __init__(self, sites: bool = False):
        super().__init__("cpu")
        self.cost = OpCost()
        self.suspend = 0
        self.live = 0
        self.peak = 0
        self.sites = sites
        self.unroll = False
        self._storages: dict[int, tuple[weakref.finalize, int, tuple]] = {}
        self._site_live: Counter = Counter()
        self._peak_sites: dict = {}
        self._args: set[int] = set()
        self._dtype_counts: Counter = Counter()
        self._spans: dict = {}

    # -- storage -------------------------------------------------------------
    def _track(self, t: torch.Tensor, op: str) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        site = (op, _site() if self.sites and op != "argument" else "")
        fin = weakref.finalize(st, self._free, key, n)
        fin.atexit = False
        self._storages[key] = (fin, n, site)
        self.live += n
        if self.sites:
            self._site_live[site] += n
            if self.live > self.peak:
                self._peak_sites = dict(self._site_live)
        self.peak = max(self.peak, self.live)

    def _free(self, key: int, n: int) -> None:
        e = self._storages.pop(key, None)
        if e is not None:
            self.live -= n
            if self.sites:
                self._site_live[e[2]] -= n

    def peak_sites(self) -> list[dict]:
        """The live bytes at the peak by (aten op, site), largest first."""
        return [{"op": op, "site": site, "bytes": n} for (op, site), n in
                sorted(self._peak_sites.items(), key=lambda e: -e[1]) if n]

    def add_arguments(self, tree) -> int:
        n0 = self.live
        for t in _storage_tensors(tree):
            self._track(t, "argument")
            self._args.add(id(t.untyped_storage()))
        return self.live - n0

    def classify_outputs(self, tree) -> tuple[int, int]:
        seen, out, alias = set(), 0, 0
        for t in _storage_tensors(tree):
            st = t.untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            out += st.nbytes()
            if id(st) in self._args:
                alias += st.nbytes()
        return out, alias

    def release(self) -> None:
        for fin, _, _ in self._storages.values():
            fin.detach()
        self._storages.clear()

    # -- counting --------------------------------------------------------------
    def count_global(self, func, args, kwargs) -> None:
        from torch.utils.flop_counter import flop_registry
        fn = flop_registry.get(func._overloadpacket)
        if fn is None:
            return
        self.suspend += 1
        try:
            out = func(*args, **kwargs)
            self.cost.flops_global += fn(*args, **kwargs, out_val=out)
        except Exception:  # noqa: BLE001 — the raw total is advisory
            pass
        finally:
            self.suspend -= 1

    def _on_op(self, func, args, kwargs):
        out = super()._on_op(func, args, kwargs)
        if self.depth:
            return out
        c = self.cost
        c.n_ops += 1
        base = func._schema.name.split("::", 1)[-1]
        ns = func._schema.name.split("::", 1)[0]
        ins = _plain_tensors((args, kwargs))
        outs = [t for t in _plain_tensors(out)
                if not any(t is i for i in ins)]
        for t in outs:
            self._dtype_counts[str(t.dtype).replace("torch.", "")] += 1
            self._track(t, base)
        from torch.utils.flop_counter import flop_registry
        fl = flop_registry.get(func._overloadpacket)
        if fl is not None:
            dt = ins[0].dtype if ins else torch.float32
            c.add_flops(float(fl(*args, **kwargs, out_val=out)),
                        _dtype_name(dt))
        if func.is_view or base in ("empty", "empty_strided", "empty_like",
                                    "wait_tensor", "lift_fresh", "detach",
                                    "alias", "_local_scalar_dense"):
            return out
        in_b = sum(_nbytes(t) for t in ins)
        out_b = sum(_nbytes(t) for t in _plain_tensors(out))
        c.hbm_bytes_hi += in_b + out_b
        if ns == "_c10d_functional" or base in COLLECTIVES:
            kind = COLLECTIVES.get(base, base)
            b = _nbytes(ins[0]) if ins else out_b
            c.collective_bytes += b
            if self._spans_hosts(args):
                c.inter_host_bytes += b
            e = c.collective_counts.setdefault(kind, {"count": 0,
                                                      "bytes": 0.0})
            e["count"] += 1
            e["bytes"] += b
            c.hbm_bytes += in_b + out_b
            return out
        if base not in MATERIALIZING:
            return out
        if base == "_to_copy" and ins and outs and \
                ins[0].dtype != outs[0].dtype:
            return out                         # a cast: fused away
        if base == "copy_" and len(ins) > 1 and ins[0].dtype != ins[1].dtype:
            return out
        if base in GATHERS:
            c.hbm_bytes += 2 * out_b
        elif base in SCATTERS:
            upd = ins[-1] if ins else None
            c.hbm_bytes += 2 * (_nbytes(upd) if upd is not None else out_b)
        else:
            c.hbm_bytes += in_b + out_b
        return out

    def _spans_hosts(self, args) -> bool:
        """Whether a functional collective's group (its last string
        argument) holds ranks of more than one host."""
        from .roofline import GPUS_PER_HOST
        name = next((a for a in reversed(args) if isinstance(a, str)), None)
        if name not in self._spans:
            try:
                import torch.distributed as dist
                from torch.distributed.distributed_c10d import (
                    _resolve_process_group)
                ranks = dist.get_process_group_ranks(
                    _resolve_process_group(name))
                self._spans[name] = len({r // GPUS_PER_HOST
                                         for r in ranks}) > 1
            except Exception:  # noqa: BLE001 — unknown group: the world's
                import torch.distributed as dist
                self._spans[name] = (dist.is_initialized() and
                                     dist.get_world_size() > GPUS_PER_HOST)
        return self._spans[name]

    # -- kernels -----------------------------------------------------------------
    def record_kernel(self, name: str, flops: float, nbytes: float,
                      outputs, dtype: str = "float32") -> None:
        c = self.cost
        c.add_flops(flops, dtype)
        c.hbm_bytes += nbytes
        c.hbm_bytes_hi += nbytes
        e = c.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                        "bytes": 0.0})
        e["calls"] += 1
        e["flops"] += flops
        e["bytes"] += nbytes
        for t in _plain_tensors(outputs):
            self._track(t, name)

    # -- loops counted by trip count -----------------------------------------------
    def _work(self) -> Counter:
        """What a loop trip adds to, flat: the cost's scalars, its FLOPs by
        dtype, each kernel's and each collective kind's entry, the aten
        histogram, the host syncs, the result dtypes and the census's
        kernel calls and eager launches."""
        c = self.cost
        w = Counter({("cost", f): getattr(c, f) for f in _SCALED})
        w.update({("dtype", k): v for k, v in c.flops_by_dtype.items()})
        for table in ("kernels", "collective_counts"):
            w.update({(table, kind, key): v for kind, e in
                      getattr(c, table).items() for key, v in e.items()})
        for attr in ("aten_ops", "host_syncs", "_dtype_counts",
                     "kernel_calls"):
            w.update({(attr, k): v for k, v in getattr(self, attr).items()})
        w[("eager_launches",)] = self.eager_launches
        return w

    def scale_since(self, before: Counter, trips: int) -> None:
        """Count the work done since ``before`` (:meth:`_work`) ``trips``
        times in all: ``trips - 1`` more of it.  Peak and live bytes stay:
        a loop's carries have one shape on every trip, so one trip's
        high-water mark is the loop's (where a caller also holds the first
        carry, later trips hold one carry more)."""
        c = self.cost
        for key, v in self._work().items():
            more = (trips - 1) * (v - before[key])
            if not more:
                continue
            what = key[0]
            if what == "cost":
                setattr(c, key[1], getattr(c, key[1]) + more)
            elif what == "dtype":
                c.flops_by_dtype[key[1]] += more
            elif what in ("kernels", "collective_counts"):
                getattr(c, what)[key[1]][key[2]] += more
            elif what == "eager_launches":
                self.eager_launches += more
            else:
                getattr(self, what)[key[1]] += more

    # -- context ---------------------------------------------------------------------
    def __enter__(self) -> "_Tracer":
        global _active
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator)

        import importlib

        from ..kernels import ops
        if _active is not None:
            raise RuntimeError("op_cost.analyze does not nest")
        for name in contracts.KERNELS:
            mod = importlib.import_module(
                f"{ops.__package__}.{contracts._IMPLS[name][0]}")
            self._swap(ops, name, self._wrap_kernel(name, mod.abstract))
        for meth in ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta"):
            orig = getattr(ShardingPropagator, meth, None)
            if orig is not None:
                self._swap(ShardingPropagator, meth, self._suspended(orig))
        self._fmode = contracts._FunctionMode(self)
        self._dmode = _CostMode(self)
        self._fmode.__enter__()
        self._dmode.__enter__()
        _active = self
        return self

    def __exit__(self, *exc) -> None:
        global _active
        _active = None
        self._dmode.__exit__(*exc)
        self._fmode.__exit__(*exc)
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()

    def _suspended(self, fn):
        def call(*args, **kwargs):
            self.suspend += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.suspend -= 1
        return call


def record_kernel(name: str, flops: float, nbytes: float, outputs,
                  dtype: str = "float32") -> None:
    """Add one kernel call's work to the running analysis (the kernels'
    ``abstract`` functions call it; a no-op outside :func:`analyze`)."""
    if _active is not None:
        _active.record_kernel(name, flops, nbytes, outputs, dtype)


def scaled(name: str, trips: int, step: Callable, *args, **kwargs):
    """One trip of a loop under :func:`analyze`, counted ``trips`` times:
    ``step(*args, **kwargs)`` runs once (its result returned, the carry of
    the next trip) and its work — FLOPs, bytes, kernel calls, collectives,
    aten ops, host syncs — is multiplied by ``trips``; ``OpCost.loops``
    adds ``trips`` to ``name``'s count (a loop run once a query group
    counts each group's trips).  Every trip must have the shapes of the one
    that ran, and there must be one (a loop of no trip is not run).  Only
    the dry run counts this way: outside :func:`analyze` it raises."""
    if _active is None:
        raise RuntimeError("op_cost.scaled counts a loop inside analyze only")
    if trips < 1:
        raise ValueError(f"loop {name!r}: {trips} trips (run none instead)")
    before = _active._work()
    out = step(*args, **kwargs)
    _active.scale_since(before, trips)
    loops = _active.cost.loops
    loops[name] = loops.get(name, 0) + trips
    return out


def counting() -> bool:
    """Whether :func:`analyze` is running and loops are counted by trip
    (:func:`scaled`), not run trip by trip (:func:`unrolled`)."""
    return _active is not None and not _active.unroll


class unrolled:
    """Context manager: under :func:`analyze`, the loops that would count
    one trip ``trips`` times (:func:`counting`) run every trip instead —
    the count :func:`scaled` must equal."""

    def __enter__(self):
        if _active is None:
            raise RuntimeError("op_cost.unrolled runs inside analyze only")
        self._was, _active.unroll = _active.unroll, True
        return self

    def __exit__(self, *exc):
        _active.unroll = self._was


@dataclasses.dataclass
class Program:
    """A device program ready to count (the counterpart of a JAX
    ``Lowered``): ``fn`` on the arguments ``make_args()`` builds, plus the
    collectives the program makes outside its traced ops (``(kind, bytes,
    inter_host)``)."""
    fn: Callable
    make_args: Callable[[], tuple]
    collectives: tuple = ()

    def analyze(self) -> OpCost:
        """One device's :class:`OpCost`."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            args = self.make_args()
        cost = analyze(self.fn, *args)
        for kind, nbytes, inter in self.collectives:
            cost.add_collective(kind, nbytes, inter_host=inter)
        return cost


def analyze(fn: Callable, *args, sites: bool = False, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` once on fake tensors and count one
    device's work.  The arguments are fake tensors (or DTensors of fake
    local shards, or modules holding them) made in one ``FakeTensorMode``,
    which is entered for the run; their storages are the program's
    arguments.  ``sites`` also names the code that made each storage and
    fills ``OpCost.peak_sites`` (slower: a stack walk an op)."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = detect_fake_mode(_storage_tensors((args, kwargs))) or \
        FakeTensorMode()
    # lint: allow-timing: fake tensors launch nothing; the host's time
    t0 = time.perf_counter()
    tracer = _Tracer(sites)
    arg_bytes = tracer.add_arguments((args, kwargs))
    try:
        with fake, tracer:
            out = fn(*args, **kwargs)
        c = tracer.cost
        c.output_bytes, c.alias_bytes = tracer.classify_outputs(out)
        c.argument_bytes = arg_bytes
        c.peak_bytes = max(tracer.peak, arg_bytes + c.output_bytes
                           - c.alias_bytes)
        c.temp_bytes = c.peak_bytes - arg_bytes - c.output_bytes + \
            c.alias_bytes
        c.aten_ops = dict(sorted(tracer.aten_ops.items()))
        c.dtypes = dict(sorted(tracer._dtype_counts.items()))
        c.host_syncs = dict(sorted(tracer.host_syncs.items()))
        c.peak_sites = tracer.peak_sites()
        c.seconds = time.perf_counter() - t0
    finally:
        tracer.release()
    return c
