"""Atomic, async checkpointing in the reference's on-disk format (port of
``repro.train.checkpoint``).

Layout (no pickle, no external deps):

    <dir>/step_000100.tmp/...      (written)
    <dir>/step_000100/             (atomic rename commit)
        manifest.json              step, flat key list, dtypes/shapes, extras
        arr_<idx>__shard0.npy      one array per leaf

The leaves are the reference's: the port's trees (the parameter layout of
``repro_torch.models.weights.param_tree``, the AdamW state of
``repro_torch.train.optimizer``) are written as the reference's tree —
each list of ``units`` (and of encoder ``layers``) stacked into one
``stack`` leaf ``[n, ...]`` — in the order ``jax.tree.flatten`` walks it
(sorted dict keys, sequences by index), under the key strings of its
``_key_strs``.  So checkpoints cross between the two packages both ways.
A bfloat16 leaf is written as the reference writes one through
``ml_dtypes`` (``.npy`` descr ``<V2``, the raw 2-byte values, dtype
``"bfloat16"`` in the manifest) without needing ``ml_dtypes``.

``restore`` checks the manifest's keys and shapes against the target
(the reference checks only the number of leaves, so leaves written in
another order would load permuted) and puts each leaf on its target
leaf's device, or, given a ``sharding_fn``, places it on the active
``DeviceMesh`` (``sharding.logical_rules``): elastic, since the files hold
whole leaves, never a device layout.

In a process group of several ranks, ``save`` and ``wait`` are
collective: every rank calls them in the same order.  Each rank
gathers each leaf whole (``full_tensor()``) on its main thread, in leaf
order; rank 0 alone writes, commits and collects old steps, so the files
are byte for byte a one-process save of the same values; the other ranks
meet it at a barrier once the commit is done (after the write of a
blocking save, in ``wait`` after an async one, whose writer thread does
file I/O only and never a collective).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.distributed.sharding import rank_and_size, whole

_STACKED = {"units": "stack", "layers": "stack"}


def _entries(tree: Any, ref: tuple = (), port: tuple = ()) -> Iterator:
    """``(reference key path, port paths of its leaves, stacked)`` for each
    leaf of the reference's layout of ``tree``, in ``jax.tree.flatten``'s
    order; a stacked leaf gathers one port leaf from each unit."""
    if isinstance(tree, dict):
        keys = {}
        for k, v in tree.items():
            stacked = k in _STACKED and isinstance(v, list)
            keys[_STACKED[k] if stacked else k] = (k, v, stacked)
        for rk in sorted(keys):
            k, v, stacked = keys[rk]
            if stacked:
                yield from _stacked(v[0], len(v), ref + (rk,), port + (k,))
            else:
                yield from _entries(v, ref + (rk,), port + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _entries(v, ref + (str(i),), port + (i,))
    else:
        yield ref, [port], False


def _stacked(unit: Any, n: int, ref: tuple, port: tuple, sub: tuple = ()
             ) -> Iterator:
    if isinstance(unit, dict):
        for k in sorted(unit):
            yield from _stacked(unit[k], n, ref + (k,), port, sub + (k,))
    else:
        yield ref, [port + (i,) + sub for i in range(n)], True


def _get(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _replace(tree: Any, new: dict, path: tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _replace(v, new, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_replace(v, new, path + (i,))
                          for i, v in enumerate(tree))
    return new[path]


def _dtype_str(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(t.numpy().dtype)


def _save_npy(path: str, t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        np.save(path, t.numpy())
        return
    with open(path, "wb") as fh:      # the bytes np.save writes for ml_dtypes
        np.lib.format.write_array_header_1_0(
            fh, {"descr": "<V2", "fortran_order": False,
                 "shape": tuple(t.shape)})
        fh.write(t.contiguous().view(torch.int16).numpy().tobytes())


def _load_npy(path: str, dtype: str) -> torch.Tensor:
    a = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _whole(t) -> torch.Tensor:
    """A leaf whole and detached: a DTensor gathered (a collective)."""
    return whole(torch.as_tensor(t).detach())


def _barrier(size: int) -> None:
    if size > 1:
        import torch.distributed as dist
        dist.barrier()


def _place(tree: Any, placements: Any, mesh) -> Any:
    """Each whole leaf of ``tree`` as a DTensor of the placements at its
    place in ``placements`` on ``mesh``."""
    from repro_torch.distributed.sharding import place

    def walk(t, pl):
        if isinstance(t, dict):
            return {k: walk(v, pl[k]) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, p) for v, p in zip(t, pl))
        return place(t, pl, mesh)
    return walk(tree, placements)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save ------------------------------------------------------------
    def save(self, step: int, tree: Any, extras: dict | None = None,
             blocking: bool = True) -> None:
        """Snapshot → write (async unless blocking) → atomic rename.  The
        snapshot is a host copy taken before this returns, so later
        in-place updates of ``tree`` do not reach the files."""
        entries = list(_entries(tree))
        keys = ["/".join(ref) for ref, _, _ in entries]
        host = []
        for _, paths, stacked in entries:
            if stacked:
                host.append(torch.stack([_whole(_get(tree, p)).cpu()
                                         for p in paths]))
            else:
                host.append(_whole(_get(tree, paths[0]))
                            .to("cpu", copy=True))
        rank, size = rank_and_size()

        def write():
            tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "keys": keys,
                        "shapes": [list(a.shape) for a in host],
                        "dtypes": [_dtype_str(a) for a in host],
                        "extras": extras or {}}
            for i, a in enumerate(host):
                _save_npy(os.path.join(tmp, f"arr_{i:05d}__shard0.npy"), a)
            with open(os.path.join(tmp, "manifest.json"), "w") as fh:
                json.dump(manifest, fh)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)       # atomic commit
            self._gc()

        self.wait()
        if rank != 0:
            if blocking:
                _barrier(size)
        elif blocking:
            write()
            _barrier(size)
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Wait for an async save to commit (collective: with several
        ranks, every rank meets rank 0 after its commit)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier(rank_and_size()[1])

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree: Any,
                sharding_fn: Callable[[Any], Any] | None = None
                ) -> tuple[Any, dict]:
        """Rebuild ``target_tree``'s structure from step ``step``'s files,
        each leaf on the device of the target's leaf, in the file's
        dtype.  With ``sharding_fn``, the restored tree (whole leaves on
        the host) goes to ``sharding_fn(tree)``, a tree of placements of
        the same structure as ``sharding.shardings_for`` gives, and each
        leaf becomes a DTensor of its placements on the active
        ``DeviceMesh``, each rank keeping its own shard (no collective):
        any mesh, whatever the mesh that saved it."""
        if sharding_fn is not None:
            from repro_torch.distributed.sharding import get_device_mesh
            mesh = get_device_mesh()
            if mesh is None:
                raise ValueError(
                    "restore with a sharding_fn places leaves on the "
                    "DeviceMesh of the active logical_rules; none is active")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as fh:
            manifest = json.load(fh)
        entries = list(_entries(target_tree))
        if len(entries) != len(manifest["keys"]):
            raise ValueError(
                f"checkpoint has {len(manifest['keys'])} leaves, target has "
                f"{len(entries)} — structure mismatch")
        new = {}
        for i, (ref, paths, stacked) in enumerate(entries):
            key = "/".join(ref)
            first = torch.as_tensor(_get(target_tree, paths[0]))
            shape = ([len(paths)] if stacked else []) + list(first.shape)
            if manifest["keys"][i] != key or manifest["shapes"][i] != shape:
                raise ValueError(
                    f"checkpoint leaf {i} is {manifest['keys'][i]} "
                    f"{manifest['shapes'][i]}, the target's {key} {shape}")
            a = _load_npy(os.path.join(path, f"arr_{i:05d}__shard0.npy"),
                          manifest["dtypes"][i])
            if sharding_fn is not None:        # placed below
                new.update(zip(paths, a if stacked else [a]))
            elif stacked:
                for j, p in enumerate(paths):
                    new[p] = a[j].to(first.device, copy=True)
            else:
                new[paths[0]] = a.to(first.device)
        tree = _replace(target_tree, new)
        if sharding_fn is not None:
            tree = _place(tree, sharding_fn(tree), mesh)
        return tree, manifest["extras"]
