"""Dry run: plan every (architecture × run shape × production mesh) cell,
and Dumpy's own build and search cells, at full size without allocating
(port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dumpy --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --cells xlstm-1.3b:train_4k

Each cell runs once on fake tensors (``FakeTensorMode``): the parameters,
optimizer state and batch are DTensors of fake local shards, placed by the
logical sharding rules (:func:`rules_for`, ``sharding.shardings_for``) on
the reference's named production mesh, a ``DeviceMesh`` over a ``"fake"``
process group of 256 or 512 ranks that this process drives as rank 0; the
model runs inside ``implicit_replication()`` (its constants are plain
tensors) and ``distributed.op_cost`` counts one device's FLOPs, HBM bytes,
collective bytes and live memory.  The record has the reference's keys
(``cost_raw``, the unscaled FlopCounter total, in place of
``cost_xla_raw``) and a three-term H100 roofline
(``distributed.roofline``).  A cell that cannot be traced records
``error`` with the op that stopped it.  Dumpy's exact cells count their
host-driven loops by trip count, every span and walk chunk run, and so
do the models' sequence loops (``models.common.scan``: xLSTM's chunks and
steps, forward and backward); the record's ``cost.loops`` sums them.

Artifacts: ``artifacts/dryrun/<arch>__<shape>__<mesh>.json``.  CUDA unless
``--device cpu`` is given (the tracing is the same; fake tensors allocate
nothing on either).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, cell_applicable
from repro_torch.core.device_index import resolve_device
from repro_torch.distributed import op_analysis, op_cost, roofline
from repro_torch.distributed.sharding import (DEFAULT_RULES, fake_world,
                                              local_shape, logical_rules,
                                              place, shardings_for)
from repro_torch.launch.mesh import PRODUCTION_MESHES, production_device_mesh
from repro_torch.models import registry, transformer as tfm
from repro_torch.models.common import PSpec, logical_tree, map_tree, zip_tree
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (make_microbatched_train_step,
                                          make_train_step)

DUMPY_KINDS = ("build", "build_bottomup", "search", "search_sharded",
               "search_extended", "search_dtw", "search_approx",
               "search_bucket", "serving")


def _mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def rules_for(cfg, shape, mesh) -> dict:
    """The reference's rules for one cell: ``DEFAULT_RULES`` with the batch
    unsharded where the global batch does not divide the data axes, and,
    for decode, parameters replicated over them where the model-sharded
    weights fit in about half of a device's memory."""
    sizes = _mesh_sizes(mesh)
    rules = dict(DEFAULT_RULES)
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    if shape.global_batch % dp != 0:
        if shape.global_batch % sizes.get("data", 1) == 0:
            rules["batch"] = "data"
        else:
            rules["batch"] = None
    if shape.kind == "decode":
        param_gib = tfm.count_params(cfg) * 2 / sizes["model"] / 2**30
        if param_gib <= 8.0:
            rules["embed_fsdp"] = None
    return rules


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_specs(v, f"{prefix}/{k}")
    elif isinstance(tree, PSpec):
        yield prefix.lstrip("/"), tree


def count_params_split(cfg) -> tuple[float, float]:
    """(total, active) parameter counts; active discounts unrouted
    experts."""
    total = active = 0.0
    for keys, spec in _flat_specs(tfm.init_specs(cfg)):
        n = float(math.prod(spec.shape))
        total += n
        if cfg.moe and "/moe/" in f"/{keys}/" and any(
                k in keys for k in ("w_gate", "w_up", "w_down")) and \
                "sh_" not in keys:
            n = n * cfg.moe.top_k / cfg.moe.n_experts
        active += n
    return total, active


def place_tree(abs_tree, placements_tree, mesh):
    """Fake global tensors → DTensors of fake local shards (even shards of
    the placements; nothing is allocated)."""
    def leaf(a, pl):
        with a.fake_mode:
            loc = torch.empty(local_shape(a.shape, pl, mesh), dtype=a.dtype,
                              device=a.device)
        return place(loc, pl, mesh, local=True)
    return zip_tree(leaf, abs_tree, placements_tree)


def _unit_slices(cfg, placed: dict, key: str = "stack",
                 n: int | None = None) -> list:
    """The units' DTensor slices of a placed stacked tree (views of its
    local shards: the units share the stacked leaves' storage)."""
    from torch.distributed.tensor import DTensor, Shard
    n = cfg.n_units if n is None else n

    def one(d, i):
        pl = tuple(Shard(p.dim - 1) if p.is_shard() else p
                   for p in d.placements)
        return DTensor.from_local(d.to_local()[i], d.device_mesh, pl,
                                  run_check=False)
    return [map_tree(lambda d: one(d, i), placed[key]) for i in range(n)]


def port_layout(cfg, placed: dict) -> dict:
    """A placed parameter (or moment) tree in the stacked layout → the
    port's layout (``Transformer``'s), units as slices."""
    out = {k: v for k, v in placed.items() if k not in ("stack", "encoder")}
    out["units"] = _unit_slices(cfg, placed)
    if "encoder" in placed:
        out["encoder"] = {
            "layers": _unit_slices(cfg, placed["encoder"],
                                   n=cfg.encoder_layers),
            "final_norm": placed["encoder"]["final_norm"]}
    return out


def adamw_for(cfg) -> opt.AdamWConfig:
    """The reference's optimizer of a train cell: bf16 accumulation and
    math travel with bf16 moments (the big-model memory mode)."""
    bf16 = cfg.moment_dtype == "bfloat16"
    return opt.AdamWConfig(moment_dtype=cfg.moment_dtype,
                           accum_dtype="bfloat16" if bf16 else "float32",
                           math_dtype="bfloat16" if bf16 else "float32")


def cell_program(cfg, shape, mesh, rules, device):
    """``(step function, args)`` of one LM cell on fake DTensors, made in a
    new ``FakeTensorMode`` (the counterpart of ``jax.jit(...).lower``'s
    inputs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), logical_rules(mesh, rules):
        params_abs = tfm.abstract_params(cfg, device)
        params_log = logical_tree(tfm.init_specs(cfg))
        params_pl = shardings_for(params_abs, params_log)
        model = tfm.Transformer(cfg, port_layout(
            cfg, place_tree(params_abs, params_pl, mesh)))
        batch_abs = registry.input_specs(cfg, shape, device)
        batch_log = registry.batch_logical(cfg, shape)
        batch = place_tree(batch_abs, shardings_for(batch_abs, batch_log),
                           mesh)
        if shape.kind == "train":
            ocfg = adamw_for(cfg)
            step = (make_microbatched_train_step(cfg, ocfg, cfg.grad_accum)
                    if cfg.grad_accum > 1 else make_train_step(cfg, ocfg))
            st_abs = opt.abstract_state(params_abs, ocfg)
            st_pl = shardings_for(st_abs, opt.state_logical(params_log))
            st = place_tree(st_abs, st_pl, mesh)
            state = {"m": port_layout(cfg, st["m"]),
                     "v": port_layout(cfg, st["v"]), "step": st["step"]}
            return step, (model, state, batch)
        if shape.kind == "prefill":
            # inference runs without autograd, as launch/serve.py does
            return torch.no_grad()(registry.make_prefill_step(cfg)), \
                (model, batch)
        batch["cache"] = _cache_layout(cfg, batch["cache"])
        serve = registry.make_decode_step(cfg)
        last = shape.seq_len - 1

        @torch.no_grad()
        def decode_step(model, batch):
            # the port's decode position is a host int (the reference's a
            # traced scalar): the step decodes at the cache's last slot
            return serve(model, dict(batch, pos=last))
        return decode_step, (model, batch)


def _cache_layout(cfg, placed: dict) -> dict:
    out = {"units": _unit_slices(cfg, placed)}
    if "rem" in placed:
        out["rem"] = placed["rem"]
    return out


@contextlib.contextmanager
def traced(mesh, rules):
    """The context a cell's step runs in: ``rules`` on ``mesh``, and
    DTensor's implicit replication of the plain tensors the model makes
    (its constants)."""
    from torch.distributed.tensor.experimental import implicit_replication
    with logical_rules(mesh, rules), implicit_replication():
        yield


def _first_line(e: BaseException) -> str:
    return f"{type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}"


def lower_cell(arch: str, shape_name: str, mesh, mesh_name: str,
               device: str | torch.device = "cuda") -> dict:
    """One LM cell's record (the reference's ``lower_cell``)."""
    return lower_cell_cost(arch, shape_name, mesh, mesh_name, device)[0]


def lower_cell_cost(arch: str, shape_name: str, mesh, mesh_name: str,
                    device: str | torch.device = "cuda",
                    sites: bool = False) -> tuple[dict, "op_cost.OpCost"]:
    """:func:`lower_cell`'s record and the ``OpCost`` behind it (None for
    a skipped cell); ``sites`` fills its ``peak_sites``."""
    cfg = registry.get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skipped": why}, None
    rules = rules_for(cfg, shape, mesh)
    t0 = time.time()
    step, args = cell_program(cfg, shape, mesh, rules, device)
    t_lower = time.time() - t0
    with traced(mesh, rules):
        cost = op_cost.analyze(step, *args, sites=sites)
    return cell_record(arch, shape_name, mesh_name, cfg, shape,
                       math.prod(mesh.shape), cost, t_lower), cost


def cell_record(arch, shape_name, mesh_name, cfg, shape, n_dev, cost,
                t_lower: float) -> dict:
    total_p, active_p = count_params_split(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mf = roofline.model_flops_estimate(
        active_p, tokens, "train" if shape.kind == "train" else "infer")
    rl = _roofline(cost, n_dev, mf)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "n_devices": n_dev,
        "params_total": total_p, "params_active": active_p,
        "tokens_per_step": tokens,
        "lower_s": round(t_lower, 1), "compile_s": round(cost.seconds, 1),
        "memory": cost.memory(),
        "cost_raw": {"flops": cost.flops_global},
        "cost": _cost_field(cost),
        "collectives": op_analysis.collective_stats(cost),
        "op_census": op_analysis.op_census(cost),
        "roofline": rl.as_dict(),
    }


def _cost_field(cost) -> dict:
    return {"flops_per_device": cost.flops,
            "flops_by_dtype": cost.flops_by_dtype,
            "hbm_bytes_per_device": cost.hbm_bytes,
            "hbm_bytes_pessimistic": cost.hbm_bytes_hi,
            "collective_bytes_per_device": cost.collective_bytes,
            "inter_host_bytes_per_device": cost.inter_host_bytes,
            "unknown_loops": cost.unknown_loops, "loops": cost.loops,
            "kernels": cost.kernels,
            "host_syncs": cost.host_syncs,
            "analyze_s": round(cost.seconds, 1)}


def _roofline(cost, n_dev: int, model_flops: float):
    return roofline.analyze(
        flops_per_device=cost.flops, bytes_per_device=cost.hbm_bytes,
        collective_bytes_per_device=cost.collective_bytes,
        n_devices=n_dev, model_flops=model_flops,
        flops_by_dtype=cost.flops_by_dtype,
        inter_host_bytes=cost.inter_host_bytes)


def lower_dumpy_cell(mesh, mesh_name: str, kind: str,
                     device: str | torch.device = "cuda") -> dict:
    """The paper's own technique on the production mesh (the reference's
    ``lower_dumpy_cell``): one device's program at one shard's shapes, the
    shard count being the mesh's pod × data."""
    from repro_torch.core import distributed as D

    w = 16
    n_series, length = 1 << 22, 256          # 4M × 256 f32 = 4 GB collection
    kw = dict(n_series=n_series, length=length, w=w, device=device)
    lowerers = {
        "build": lambda: D.lower_build_step(mesh, **kw),
        "build_bottomup": lambda: D.lower_build_bottomup(
            mesh, n_series=n_series, w=w, device=device),
        "search": lambda: D.lower_search_oneshot(mesh, **kw),
        "search_sharded": lambda: D.lower_search_sharded(mesh, **kw),
        "search_extended": lambda: D.lower_search_extended(mesh, **kw),
        "search_dtw": lambda: D.lower_search_dtw(mesh, **kw),
        "search_approx": lambda: D.lower_search_approx(mesh, **kw),
        "search_bucket": lambda: D.lower_search_bucket(mesh, **kw),
        "serving": lambda: D.lower_serving_head(mesh, device=device),
    }
    rec = {"arch": f"dumpy-{kind}", "shape": "n4M_len256", "mesh": mesh_name,
           "n_devices": math.prod(mesh.shape)}
    cost = lowerers[kind]().analyze()
    mf = (2.0 * n_series * length * w if kind.startswith("build")
          else 2.0 * 64 * n_series * length)
    rl = _roofline(cost, math.prod(mesh.shape), mf)
    rec.update({"compile_s": round(cost.seconds, 1),
                "memory": cost.memory(), "cost": _cost_field(cost),
                "collectives": op_analysis.collective_stats(cost),
                "op_census": op_analysis.op_census(cost),
                "roofline": rl.as_dict()})
    return rec


def _meshes(which: str):
    return {"single": ["pod_16x16"], "multi": ["multi_pod_2x16x16"],
            "both": ["pod_16x16", "multi_pod_2x16x16"]}[which]


def _write(out: str, tag: str, rec: dict) -> None:
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, tag + ".json"), "w") as fh:
        json.dump(rec, fh, indent=1)


def _summary(rec: dict) -> str:
    if "error" in rec:
        return f"FAILED: {rec['error'].splitlines()[0]}"
    if "skipped" in rec:
        return f"skipped: {rec['skipped']}"
    r = rec["roofline"]
    return (f"ok analyze={rec['compile_s']}s "
            f"mem/dev={rec['memory']['peak_per_device'] / 2**30:.2f}GiB "
            f"bottleneck={r['bottleneck']} step={r['step_s']:.6g}s "
            f"terms(c/m/x)={r['compute_s']:.3g}/{r['memory_s']:.3g}/"
            f"{r['collective_s']:.3g}s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="architectures (comma-separated), 'all', or "
                         "'dumpy' (the index cells); 'all' includes the "
                         "dumpy cells")
    ap.add_argument("--shape", default="all",
                    help="run shapes (comma-separated) or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--kinds", default="all",
                    help="comma-separated dumpy cells (default all)")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors and the mesh "
                         "(cuda unless cpu is asked)")
    ap.add_argument("--cells", default=None,
                    help="comma-separated arch:shape cells, counted in "
                         "place of --arch x --shape (no dumpy cells)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    named = args.arch.split(",")
    archs = (registry.ARCH_NAMES if args.arch == "all"
             else [a for a in named if a != "dumpy"])
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    kinds = (list(DUMPY_KINDS) if args.kinds == "all"
             else args.kinds.split(","))
    dumpy = args.cells is None and (args.arch == "all" or "dumpy" in named)
    lm_cells = ([tuple(c.split(":")) for c in args.cells.split(",")]
                if args.cells else [(a, s) for a in archs for s in shapes])
    failures = 0
    for mesh_name in _meshes(args.mesh):
        shape_, _ = PRODUCTION_MESHES[mesh_name]
        with fake_world(math.prod(shape_)):
            mesh = production_device_mesh(
                multi_pod=mesh_name.startswith("multi"), device=device)
            cells = lm_cells + [("dumpy", k) for k in
                                (kinds if dumpy else ())]
            for arch, shape in cells:
                tag = (f"dumpy-{shape}__{mesh_name}" if arch == "dumpy"
                       else f"{arch}__{shape}__{mesh_name}")
                if args.skip_existing and os.path.exists(
                        os.path.join(args.out, tag + ".json")):
                    print(f"[skip] {tag}")
                    continue
                print(f"[cell] {tag} ...", flush=True)
                try:
                    rec = (lower_dumpy_cell(mesh, mesh_name, shape, device)
                           if arch == "dumpy" else
                           lower_cell(arch, shape, mesh, mesh_name, device))
                except Exception as e:  # noqa: BLE001 — report, keep sweeping
                    rec = {"arch": arch if arch != "dumpy"
                           else f"dumpy-{shape}",
                           "shape": shape if arch != "dumpy"
                           else "n4M_len256",
                           "mesh": mesh_name, "error": _first_line(e),
                           "traceback": traceback.format_exc()[-2000:]}
                    failures += 1
                _write(args.out, tag, rec)
                print(f"  {_summary(rec)}", flush=True)
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
