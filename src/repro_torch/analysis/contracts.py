"""Extract, diff and police per-entry contracts (port of
``repro.analysis.contracts``).

A *contract* is the small structural fingerprint of one entry point's run,
taken by a :class:`Census` (a ``TorchFunctionMode`` over the torch calls the
port makes and a ``TorchDispatchMode`` over the aten ops they dispatch):

* ``kernel_calls``  — calls of each ``repro_torch.kernels.ops`` kernel
  (``histogram``) and a digest of their ordered ``(name, shapes)`` sequence
  (``sequence``).  The kernels are counted by swapping the functions of
  ``kernels.ops`` for counting wrappers inside the census; the search calls
  ``ops.<name>`` at call time, so every call is seen.  The ops *inside* a
  kernel call are suspended: a call counts as one kernel call whether it
  reaches the CUDA kernel or its CPU twin, so the CPU census and the card's
  describe the same program.  A kernel or twin that runs outside its
  ``ops`` wrapper raises :class:`CensusError` (it would be invisible);
* ``aten_ops``      — histogram of the aten ops outside kernel calls: the
  eager launches (``eager_launches`` counts those that launch work: views,
  ``empty*`` and scalar reads left out);
* ``dtypes``        — the dtypes of the op results on the device path (a
  set: per-op counts follow the aten decomposition, which moves with the
  torch version; a float64 showing up does not);
* ``host_syncs``    — per torch call that makes the host wait for the
  device, keyed by the call (``Tensor.cpu``, ``Tensor.__bool__``,
  ``Tensor.to`` for an upload from pageable memory, ...).  A call counts
  once however many times it waits inside.  On the card these are the
  warnings of ``torch.cuda.set_sync_debug_mode("warn")`` raised while the
  call runs (``kernel:<name>`` inside a kernel wrapper, ``other`` outside
  any torch call); on the CPU the census predicts them: the sync-inducing
  aten ops (:data:`SYNC_ATEN`, boolean indexing) on a device tensor, and
  the transfers across the host boundary, with a residency model that
  marks host tensors (``torch.from_numpy``, factories without a
  ``device``, the results of ``.cpu()``) and treats every other tensor as
  on the device;
* ``device_moves``  — copies between two devices (seen only on a mesh of
  distinct devices);
* ``peak_bytes``    — ``torch.cuda.max_memory_allocated`` over the run, on
  the card only; printed, not diffed.

The reference's ``control_flow`` (while/conditional counts) and
``donation`` (input/output aliasing) describe a compiled XLA module and
have no eager counterpart: a Python loop leaves no trace, and eager ops
allocate their results.  The loops show up in ``kernel_calls`` and
``aten_ops`` instead.

Counts are exact-diffed against the golden ``contracts_torch.json``.  The
``aten_ops`` histogram (and ``eager_launches``) is compared only under the
torch version that extracted the golden: the golden of the reference was
extracted under another JAX than the one installed and fails on every field
for it.  ``policy_violations`` enforces what no golden may bless: float64
on a device path, a host sync in an entry declared sync-free, and a device
move in an entry declared shard-local.
"""
from __future__ import annotations

import functools
import hashlib
import warnings
import weakref
from collections import Counter

import torch
from torch.overrides import TorchFunctionMode, resolve_name
from torch.utils._python_dispatch import (TorchDispatchMode,
                                           _disable_current_modes)
from torch.utils._pytree import tree_flatten

#: the ``kernels.ops`` functions that reach a hand-written kernel
KERNELS = ("sax_encode", "pairwise_l2", "lb_paa_interval", "lb_keogh",
           "lb_improved", "dtw_band")
#: each kernel's CUDA wrapper ``(module, function)`` and CPU twin in
#: ``kernels.ref``: guarded so a call that bypasses ``ops`` is an error
_IMPLS = {"sax_encode": ("sax_encode", "sax_encode_ref"),
          "pairwise_l2": ("pairwise_l2", "pairwise_l2_ref"),
          "lb_paa_interval": ("lb_isax", "lb_paa_interval_in_order"),
          "lb_keogh": ("lb_keogh", "lb_keogh_ref"),
          "lb_improved": ("lb_improved", "lb_improved_ref"),
          "dtw_band": ("dtw_band", "dtw_band_ref")}
#: aten ops that read the device from the host (on a device tensor)
SYNC_ATEN = frozenset({
    "_local_scalar_dense", "nonzero", "masked_select", "_unique", "_unique2",
    "unique_dim", "unique_consecutive", "unique_dim_consecutive", "bincount",
    "equal"})
#: aten ops that take a boolean mask as an index (and so call ``nonzero``)
_INDEX_OPS = frozenset({"index", "index_put", "index_put_",
                        "_index_put_impl_"})
#: aten ops that launch no device work
_NO_LAUNCH = frozenset({"empty", "empty_strided", "empty_like", "lift_fresh",
                        "_local_scalar_dense", "detach", "alias"})
#: torch calls that create a tensor; without ``device=`` it is on the host
_FACTORIES = frozenset({
    "torch.tensor", "torch.as_tensor", "torch.asarray", "torch.zeros",
    "torch.ones", "torch.full", "torch.empty", "torch.arange",
    "torch.linspace", "torch.eye", "torch.rand", "torch.randn",
    "torch.randint", "torch.randperm", "torch.empty_strided",
    "torch.scalar_tensor"})
#: the factories that copy host data (an upload when given a device)
_DATA_FACTORIES = frozenset({"torch.tensor", "torch.as_tensor",
                             "torch.asarray"})
#: Tensor methods that read a device tensor's values on the host
_DOWNLOADS = frozenset({"cpu", "numpy", "tolist", "__array__"})
_SYNC_WARNING = "synchroniz"


class CensusError(RuntimeError):
    """The census cannot see what ran (a kernel outside its ``ops``
    wrapper)."""


class HostSyncError(RuntimeError):
    """A host sync under ``guards.no_host_sync()`` on the CPU."""


def _short(name: str) -> str:
    return name[len("torch."):] if name.startswith("torch.Tensor.") else name


def _digest(seq) -> str:
    return hashlib.sha256(repr(list(seq)).encode()).hexdigest()[:16]


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _signature(args, kwargs) -> tuple:
    """A kernel call's arguments as shapes (tensors) and values (the rest),
    keyword arguments by name."""
    def one(a):
        return ("T", tuple(a.shape)) if isinstance(a, torch.Tensor) else a
    return (tuple(one(a) for a in args)
            + tuple((k, one(v)) for k, v in sorted(kwargs.items())))


def _to_target(args, kwargs):
    """``(target device or None, non_blocking)`` of a ``Tensor.to`` call."""
    dev = kwargs.get("device")
    for a in args[1:]:
        if isinstance(a, (str, torch.device)):
            dev = a
        elif isinstance(a, torch.Tensor):
            dev = a.device
    return dev, bool(kwargs.get("non_blocking", False))


class _FunctionMode(TorchFunctionMode):
    def __init__(self, census: "Census"):
        super().__init__()
        self.c = census

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return self.c._on_call(func, args, kwargs or {})


class _DispatchMode(TorchDispatchMode):
    def __init__(self, census: "Census"):
        super().__init__()
        self.c = census

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self.c._on_op(func, args, kwargs or {})


class Census:
    """Context manager: the contract of everything the port runs inside it
    (see the module docstring).  ``device`` is the device the entry runs
    on; ``strict=True`` raises :class:`HostSyncError` at the first
    predicted sync (the CPU form of ``guards.no_host_sync``).  Not
    thread-safe: run one entry from one thread."""

    def __init__(self, device: str | torch.device = "cuda", *,
                 strict: bool = False):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.strict = strict
        self.kernel_calls: Counter = Counter()
        self.kernel_seq: list = []
        self.aten_ops: Counter = Counter()
        self.aten_seq: list[str] = []
        self.eager_launches = 0
        self.dtypes: set[str] = set()
        self.host_syncs: Counter = Counter()
        self.device_moves = 0
        self.peak_bytes: int | None = None
        self.base_bytes: int | None = None   # allocated when it began
        self.depth = 0               # > 0 inside a kernel call
        self._host: dict[int, weakref.ref] = {}
        self._host_ctx = False       # a host factory call is running
        self._call_syncs = False     # an op of the current call synced
        self._log: list = []
        self._scanned = self._sync_total = self._attributed = 0
        self._undo: list = []

    # -- residency (the CPU model) ------------------------------------------
    def _is_host(self, t: torch.Tensor) -> bool:
        if self.cuda:
            return t.device.type == "cpu"
        r = self._host.get(id(t))
        return r is not None and r() is t

    def _mark_host(self, t: torch.Tensor) -> None:
        self._host[id(t)] = weakref.ref(t)

    def _alias(self, t: torch.Tensor) -> torch.Tensor:
        """A new tensor object over ``t``'s storage, so a transfer on the
        CPU (where ``.cpu()`` / ``.to()`` return ``self``) gets its own
        residency."""
        self.depth += 1
        try:
            return t.detach()
        finally:
            self.depth -= 1

    def _n_syncs(self) -> int:
        """Sync warnings recorded so far (the log is scanned once)."""
        for w in self._log[self._scanned:]:
            self._sync_total += _SYNC_WARNING in str(w.message)
        self._scanned = len(self._log)
        return self._sync_total

    # -- hooks ----------------------------------------------------------------
    def _on_call(self, func, args, kwargs):
        name = resolve_name(func) or getattr(func, "__name__", repr(func))
        if self.depth or name.endswith("__get__"):
            return func(*args, **kwargs)
        if self.cuda:
            n0 = self._n_syncs()
            out = func(*args, **kwargs)
            n = self._n_syncs() - n0
            self._attributed += n
            if n:
                self.host_syncs[_short(name)] += 1
            return out
        self._call_syncs = False
        host_factory = name in _FACTORIES and kwargs.get("device") is None
        self._host_ctx = host_factory
        try:
            out = func(*args, **kwargs)
        finally:
            self._host_ctx = False
        synced = self._call_syncs
        meth = name.rsplit(".", 1)[-1]
        self_t = args[0] if args and isinstance(args[0], torch.Tensor) \
            else None
        if host_factory:
            for t in _tensors(out):
                self._mark_host(t)
        elif name in _DATA_FACTORIES and kwargs.get("device") is not None \
                and args and not isinstance(args[0], torch.Tensor):
            synced = True                       # an upload of host data
        elif self_t is not None and name.startswith("torch.Tensor."):
            if meth in _DOWNLOADS and not self._is_host(self_t):
                synced = True
                if meth == "cpu":
                    out = self._alias(out) if out is self_t else out
                    self._mark_host(out)
            elif meth == "__setitem__" and not self._is_host(self_t) \
                    and not isinstance(args[2], torch.Tensor) \
                    and _tensors(args[1]):
                # a scalar assigned through a tensor index: torch stages the
                # scalar on the host and copies it up (a sync on a card)
                synced = True
            elif meth in ("to", "cuda") and self._is_host(self_t):
                target, non_blocking = _to_target(args, kwargs)
                if target is not None or meth == "cuda":
                    synced = synced or not non_blocking
                    out = self._alias(out) if out is self_t else out
                    self._host.pop(id(out), None)
        if synced:
            self.host_syncs[_short(name)] += 1
            if self.strict:
                raise HostSyncError(
                    f"{_short(name)} waits for the device inside "
                    f"no_host_sync()")
        return out

    def _on_op(self, func, args, kwargs):
        if self.depth:
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        base = func._schema.name.split("::", 1)[-1]
        full = str(func)
        self.aten_ops[full] += 1
        self.aten_seq.append(full)
        if not (func.is_view or base in _NO_LAUNCH):
            self.eager_launches += 1
        ins = _tensors((args, kwargs))
        outs = [t for t in _tensors(out) if not any(t is i for i in ins)]
        if self.cuda:
            on_dev = [t for t in outs if t.device.type != "cpu"]
            if base in ("_to_copy", "copy_"):
                src = args[1] if base == "copy_" else args[0]
                dst = args[0] if base == "copy_" else out
                if (src.device != dst.device and src.device.type != "cpu"
                        and dst.device.type != "cpu"):
                    self.device_moves += 1
        else:
            dev_in = any(not self._is_host(t) for t in ins)
            if self._host_ctx or (ins and not dev_in):
                for t in outs:
                    self._mark_host(t)
                on_dev = []
            else:
                on_dev = outs
            if dev_in and self._syncs(base, args, kwargs):
                self._call_syncs = True
            if base == "copy_" and len(args) > 1 \
                    and self._is_host(args[0]) != self._is_host(args[1]) \
                    and not kwargs.get("non_blocking",
                                       args[2] if len(args) > 2 else False):
                self._call_syncs = True
        for t in on_dev:
            self.dtypes.add(str(t.dtype).replace("torch.", ""))
        return out

    @staticmethod
    def _syncs(base: str, args, kwargs) -> bool:
        """Whether this aten op waits for the device on a card."""
        if base in SYNC_ATEN:
            return True
        if base in _INDEX_OPS and len(args) > 1:
            return any(isinstance(i, torch.Tensor)
                       and i.dtype in (torch.bool, torch.uint8)
                       for i in args[1])
        if base == "repeat_interleave":
            return kwargs.get("output_size") is None and any(
                isinstance(a, torch.Tensor) for a in args)
        return False

    # -- the kernel wrappers ----------------------------------------------------
    def _wrap_kernel(self, name: str, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if self.depth:
                return fn(*args, **kwargs)
            self.kernel_calls[name] += 1
            self.kernel_seq.append((name, _signature(args, kwargs)))
            n0 = self._n_syncs() if self.cuda else 0
            self.depth += 1
            try:
                with torch._C.DisableTorchFunction(), \
                        _disable_current_modes():
                    return fn(*args, **kwargs)
            finally:
                self.depth -= 1
                if self.cuda:
                    n = self._n_syncs() - n0
                    self._attributed += n
                    if n:
                        self.host_syncs[f"kernel:{name}"] += 1
        return call

    def _guard_impl(self, name: str, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not self.depth:
                raise CensusError(
                    f"{fn.__module__}.{fn.__name__} ran outside "
                    f"ops.{name}: the census cannot count it")
            return fn(*args, **kwargs)
        return call

    def _swap(self, mod, attr: str, new) -> None:
        self._undo.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, new)

    def __enter__(self) -> "Census":
        import importlib

        from ..kernels import ops, ref
        for name in KERNELS:
            self._swap(ops, name, self._wrap_kernel(name, getattr(ops, name)))
            mod_name, twin = _IMPLS[name]
            mod = importlib.import_module(f"{ops.__package__}.{mod_name}")
            self._swap(mod, name, self._guard_impl(name, getattr(mod, name)))
            self._swap(ref, twin, self._guard_impl(name, getattr(ref, twin)))
        if not self.cuda:
            # torch.from_numpy takes no tensor, so no mode sees it: its
            # results are marked host here
            from_numpy = torch.from_numpy

            def host_from_numpy(a):
                t = from_numpy(a)
                self._mark_host(t)
                return t
            self._swap(torch, "from_numpy", host_from_numpy)
        else:
            self._prev_sync_mode = torch.cuda.get_sync_debug_mode()
            self._wctx = warnings.catch_warnings(record=True)
            self._log = self._wctx.__enter__()
            warnings.simplefilter("always")
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            self.base_bytes = int(torch.cuda.memory_allocated(self.device))
            torch.cuda.set_sync_debug_mode("warn")
        self._fmode, self._dmode = _FunctionMode(self), _DispatchMode(self)
        self._fmode.__enter__()
        self._dmode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._dmode.__exit__(*exc)
        self._fmode.__exit__(*exc)
        if self.cuda:
            torch.cuda.set_sync_debug_mode(self._prev_sync_mode)
            other = self._n_syncs() - self._attributed
            if other:
                self.host_syncs["other"] += other
            self._wctx.__exit__(*exc)
            torch.cuda.synchronize(self.device)
            self.peak_bytes = int(torch.cuda.max_memory_allocated(
                self.device))
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()

    # -- the result ---------------------------------------------------------------
    def contract(self) -> dict:
        return {
            "kernel_calls": {
                "histogram": dict(sorted(self.kernel_calls.items())),
                "sequence": _digest(self.kernel_seq)},
            "aten_ops": dict(sorted(self.aten_ops.items())),
            "eager_launches": self.eager_launches,
            "dtypes": sorted(self.dtypes),
            "host_syncs": dict(sorted(self.host_syncs.items())),
            "device_moves": self.device_moves,
            "peak_bytes": self.peak_bytes,
        }

    @property
    def n_syncs(self) -> int:
        return sum(self.host_syncs.values())


def run_entry(entry, device: str | torch.device = "cuda", *,
              warm: bool | None = None):
    """Run one registered entry under a census → ``(result, census)``.  Its
    set-up (index, ``DeviceIndex``, inputs) runs before the census; with
    ``warm`` (the default on the card) so does one call of it, since the
    first launch of each kernel loads its module (set-up, not the entry's
    contract)."""
    from . import registry
    thunk = entry.setup(registry.audit_state(device))
    cuda = torch.device(device).type == "cuda"
    if cuda if warm is None else warm:
        thunk()
        if cuda:
            torch.cuda.synchronize(device)
    with Census(device) as census:
        result = thunk()
    return result, census


def policy_violations(entry, contract: dict) -> list[str]:
    """Golden-independent invariants (see module docstring)."""
    v = []
    if entry.device_path and "float64" in contract["dtypes"]:
        v.append(f"{entry.name}: a float64 result on a device path — a "
                 f"double leaked into the device program")
    n = sum(contract["host_syncs"].values())
    if entry.sync_free and n:
        v.append(f"{entry.name}: {n} host sync(s) "
                 f"({', '.join(sorted(contract['host_syncs']))}) in an entry "
                 f"declared sync-free")
    if not entry.sharded and contract["device_moves"]:
        v.append(f"{entry.name}: {contract['device_moves']} device move(s) "
                 f"in an entry declared shard-local")
    return v


#: contract keys compared only under the golden's torch version
ATEN_KEYS = ("aten_ops", "eager_launches")
#: contract keys never diffed (device- and allocator-dependent)
UNDIFFED = ("peak_bytes",)


def aten_skip_reason(golden_torch: str | None) -> str | None:
    """Why the ``aten_ops`` histogram is not compared, or ``None`` when it
    is (the golden was extracted under the running torch version)."""
    if golden_torch == torch.__version__:
        return None
    return (f"aten_ops not compared: the golden was extracted under torch "
            f"{golden_torch}, this is torch {torch.__version__} (the aten "
            f"decomposition of an op may differ between versions)")


def _flatten(d: dict, prefix: str = "") -> dict:
    flat = {}
    for k, val in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(val, dict) and val:
            flat.update(_flatten(val, key))
        else:
            flat[key] = val
    return flat


def diff_contract(name: str, golden: dict, current: dict, *,
                  compare_aten: bool = True, keys=None) -> list[str]:
    """Human-readable drift lines (empty == no undeclared drift).  Every
    compared key is exact; ``keys`` limits the diff to those top-level
    fields."""
    def keep(key: str) -> bool:
        top = key.split(".", 1)[0]
        if top in UNDIFFED or (keys is not None and top not in keys):
            return False
        return compare_aten or top not in ATEN_KEYS

    g = {k: v for k, v in _flatten(golden).items() if keep(k)}
    c = {k: v for k, v in _flatten(current).items() if keep(k)}
    return [f"{name}: {key}: {g.get(key)!r} -> {c.get(key)!r}"
            for key in sorted(set(g) | set(c)) if g.get(key) != c.get(key)]
