"""Child processes of the dry-run tests: each job runs in its own process
(the reference needs its device count set before JAX starts; the port's
jobs start a process group) and prints one JSON object as its last line.

    python tests/_torch_dryrun_children.py <job>

Jobs: ``ref`` / ``port`` (placements of every parameter and moment leaf
of the ten reduced configs on a (4, 2) and a (2, 2, 2) mesh, and reduced
OLMo's per-device FLOPs and argument bytes for train, prefill and decode
on (1, 1) and (4, 2)); ``ref peaks`` / ``port peaks`` (the per-device
peak of each reduced config's train and prefill step on (4, 2): the
reference's ``memory_analysis`` split, the port's ``op_cost`` one, for
the kinds given or both);
``ref prod <cells>`` / ``port prod <cells>`` (the same at full size on
the 16 x 16 production mesh, for the ``arch:shape`` cells given), ``mlp``
(a column-then-row sharded MLP on (1, 2)),
``gloo`` (a real step on a one-rank gloo mesh against the plain step),
``exact <spec>`` (the reference's exact search cells lowered at the sizes
of the JSON ``spec``: ``hlo_cost`` and the loops of each).
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
COST_MESHES = {"1x1": ((1, 1), ("data", "model")),
               "4x2": ((4, 2), ("data", "model"))}
KINDS = ("train", "prefill", "decode")
B, S = 8, 32


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _norm(spec, ndim):
    out = [None if a is None else a if isinstance(a, str) else list(a)
           for a in tuple(spec)]
    return out + [None] * (ndim - len(out))


PEAK_MESH = "4x2"
PEAK_KINDS = ("train", "prefill")


def _memory(m) -> dict:
    """A ``memory_analysis`` as the dry run's record splits it."""
    return {"argument_bytes": m.argument_size_in_bytes,
            "output_bytes": m.output_size_in_bytes,
            "temp_bytes": m.temp_size_in_bytes,
            "alias_bytes": m.alias_size_in_bytes,
            "peak_per_device": (m.argument_size_in_bytes
                                + m.output_size_in_bytes
                                + m.temp_size_in_bytes
                                - m.alias_size_in_bytes)}


def ref(part: str = "", cells: str = "") -> dict:
    if part == "peaks":
        return ref_peaks()
    if part == "prod":
        return ref_prod(cells)
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    from repro.configs.base import RunShape, reduced
    from repro.distributed import hlo_cost
    from repro.distributed.sharding import (DEFAULT_RULES, logical_rules,
                                            make_mesh, shardings_for)
    from repro.launch.dryrun import rules_for
    from repro.models import registry, transformer as tfm
    from repro.models.common import logical_tree
    from repro.train import optimizer as opt
    from repro.train.train_step import make_train_step

    place = {}
    for mname, (shape, names) in MESHES.items():
        mesh = make_mesh(shape, names)
        for arch in registry.ARCH_NAMES:
            cfg = reduced(registry.get_config(arch))
            with logical_rules(mesh, DEFAULT_RULES):
                pa = tfm.abstract_params(cfg)
                pl = logical_tree(tfm.init_specs(cfg))
                oa = opt.abstract_state(pa, opt.AdamWConfig())
                tree = {"params": pa, "m": oa["m"], "v": oa["v"]}
                sh = {"params": shardings_for(pa, pl),
                      **{k: v for k, v in shardings_for(
                          oa, opt.state_logical(pl)).items()
                         if k in ("m", "v")}}
            flat_a = dict(_paths(tree))
            place[f"{arch}|{mname}"] = {
                p: _norm(s.spec, len(flat_a[p].shape))
                for p, s in _paths(sh)}
    cost = {}
    cfg = reduced(registry.get_config("olmo-1b"))
    for mname, (shape, names) in COST_MESHES.items():
        mesh = make_mesh(shape, names)
        for kind in KINDS:
            rs = RunShape("t", S, B, kind)
            with logical_rules(mesh, rules_for(cfg, rs, mesh)):
                pa = tfm.abstract_params(cfg)
                pl = logical_tree(tfm.init_specs(cfg))
                psh = shardings_for(pa, pl)
                ba = registry.input_specs(cfg, rs)
                bsh = shardings_for(ba, registry.batch_logical(cfg, rs))
                if kind == "train":
                    ocfg = opt.AdamWConfig()
                    oa = opt.abstract_state(pa, ocfg)
                    osh = shardings_for(oa, opt.state_logical(pl))
                    j = jax.jit(make_train_step(cfg, ocfg),
                                in_shardings=(psh, osh, bsh),
                                out_shardings=(psh, osh, None),
                                donate_argnums=(0, 1))
                    args = (pa, oa, ba)
                elif kind == "prefill":
                    j = jax.jit(registry.make_prefill_step(cfg),
                                in_shardings=(psh, bsh))
                    args = (pa, ba)
                else:
                    j = jax.jit(registry.make_decode_step(cfg),
                                in_shardings=(psh, bsh), donate_argnums=(1,))
                    args = (pa, ba)
                c = j.lower(*args).compile()
            cost[f"{mname}|{kind}"] = {
                "flops": hlo_cost.analyze(c.as_text()).flops,
                "argument_bytes": c.memory_analysis().argument_size_in_bytes}
    return {"placements": place, "cost": cost}


def ref_peaks() -> dict:
    """Each reduced config's train and prefill step on (4, 2), compiled
    as the reference's dry run compiles a cell (its ``rules_for``, bf16
    moments where the config asks, the train step donating its
    parameters and moments): ``memory_analysis``."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    from repro.configs.base import RunShape, reduced
    from repro.distributed.sharding import (logical_rules, make_mesh,
                                            shardings_for)
    from repro.launch.dryrun import rules_for
    from repro.models import registry, transformer as tfm
    from repro.models.common import logical_tree
    from repro.train import optimizer as opt
    from repro.train.train_step import make_train_step

    shape, names = MESHES[PEAK_MESH]
    mesh = make_mesh(shape, names)
    out = {}
    for arch in registry.ARCH_NAMES:
        cfg = reduced(registry.get_config(arch))
        for kind in PEAK_KINDS:
            rs = RunShape("t", S, B, kind)
            with logical_rules(mesh, rules_for(cfg, rs, mesh)):
                pa = tfm.abstract_params(cfg)
                pl = logical_tree(tfm.init_specs(cfg))
                psh = shardings_for(pa, pl)
                ba = registry.input_specs(cfg, rs)
                bsh = shardings_for(ba, registry.batch_logical(cfg, rs))
                if kind == "train":
                    bf16 = cfg.moment_dtype == "bfloat16"
                    ocfg = opt.AdamWConfig(
                        moment_dtype=cfg.moment_dtype,
                        accum_dtype="bfloat16" if bf16 else "float32",
                        math_dtype="bfloat16" if bf16 else "float32")
                    oa = opt.abstract_state(pa, ocfg)
                    osh = shardings_for(oa, opt.state_logical(pl))
                    j = jax.jit(make_train_step(cfg, ocfg),
                                in_shardings=(psh, osh, bsh),
                                out_shardings=(psh, osh, None),
                                donate_argnums=(0, 1))
                    args = (pa, oa, ba)
                else:
                    j = jax.jit(registry.make_prefill_step(cfg),
                                in_shardings=(psh, bsh))
                    args = (pa, ba)
                c = j.lower(*args).compile()
            out[f"{arch}|{kind}"] = _memory(c.memory_analysis())
    return out


def ref_prod(cells: str) -> dict:
    """The reference's own dry-run records of the ``arch:shape`` cells
    (comma-separated) on the 16 x 16 production mesh: their memory."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro.launch import dryrun                 # sets XLA_FLAGS first
    from repro.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=False)
    out = {}
    for cell in cells.split(","):
        arch, shape = cell.split(":")
        out[cell] = dryrun.lower_cell(arch, shape, mesh, "pod_16x16")["memory"]
    return out


def port_peaks(kinds: str = "") -> dict:
    """:func:`ref_peaks` counted by the port's dry run (``op_cost`` on a
    fake 8-rank world), for the comma-separated ``kinds`` (all by
    default)."""
    from repro_torch.configs.base import RunShape, reduced
    from repro_torch.distributed import op_cost
    from repro_torch.distributed.sharding import fake_world, named_mesh
    from repro_torch.launch import dryrun
    from repro_torch.models import registry
    shape, names = MESHES[PEAK_MESH]
    out = {}
    with fake_world(8):
        mesh = named_mesh(shape, names, "cpu")
        for arch in registry.ARCH_NAMES:
            cfg = reduced(registry.get_config(arch))
            for kind in (kinds.split(",") if kinds else PEAK_KINDS):
                rs = RunShape("t", S, B, kind)
                rules = dryrun.rules_for(cfg, rs, mesh)
                step, args = dryrun.cell_program(cfg, rs, mesh, rules, "cpu")
                with dryrun.traced(mesh, rules):
                    c = op_cost.analyze(step, *args)
                out[f"{arch}|{kind}"] = c.memory()
    return out


def port_prod(cells: str) -> dict:
    """:func:`ref_prod` counted by the port's dry run."""
    import math
    from repro_torch.distributed.sharding import fake_world
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (PRODUCTION_MESHES,
                                         production_device_mesh)
    out = {}
    with fake_world(math.prod(PRODUCTION_MESHES["pod_16x16"][0])):
        mesh = production_device_mesh(multi_pod=False, device="cpu")
        for cell in cells.split(","):
            arch, shape = cell.split(":")
            rec = dryrun.lower_cell(arch, shape, mesh, "pod_16x16", "cpu")
            out[cell] = rec["memory"]
    return out


def port(part: str = "", cells: str = "") -> dict:
    if part == "peaks":
        return port_peaks(cells)
    if part == "prod":
        return port_prod(cells)
    import torch
    from repro_torch.configs.base import RunShape, reduced
    from repro_torch.distributed import op_cost
    from repro_torch.distributed.sharding import (DEFAULT_RULES, fake_world,
                                                  logical_rules, named_mesh,
                                                  shardings_for, spec_of)
    from repro_torch.launch import dryrun
    from repro_torch.models import registry, transformer as tfm
    from repro_torch.models.common import logical_tree
    from repro_torch.train import optimizer as opt
    from torch._subclasses.fake_tensor import FakeTensorMode

    place, cost = {}, {}
    with fake_world(8):
        for mname, (shape, names) in MESHES.items():
            mesh = named_mesh(shape, names, "cpu")
            for arch in registry.ARCH_NAMES:
                cfg = reduced(registry.get_config(arch))
                with FakeTensorMode(), logical_rules(mesh, DEFAULT_RULES):
                    pa = tfm.abstract_params(cfg, "cpu")
                    pl = logical_tree(tfm.init_specs(cfg))
                    oa = opt.abstract_state(pa, opt.AdamWConfig())
                    tree = {"params": pa, "m": oa["m"], "v": oa["v"]}
                    sh = {"params": shardings_for(pa, pl),
                          "m": shardings_for(oa["m"], pl),
                          "v": shardings_for(oa["v"], pl)}
                flat_a = dict(_paths(tree))
                place[f"{arch}|{mname}"] = {
                    p: _norm(spec_of(s, mesh, len(flat_a[p].shape)),
                             len(flat_a[p].shape))
                    for p, s in _paths(sh)}
        cfg = reduced(registry.get_config("olmo-1b"))
        for mname, (shape, names) in COST_MESHES.items():
            mesh = named_mesh(shape, names, "cpu")
            for kind in KINDS:
                rs = RunShape("t", S, B, kind)
                rules = dryrun.rules_for(cfg, rs, mesh)
                step, args = dryrun.cell_program(cfg, rs, mesh, rules, "cpu")
                with dryrun.traced(mesh, rules):
                    c = op_cost.analyze(step, *args)
                cost[f"{mname}|{kind}"] = {"flops": c.flops,
                                           "argument_bytes": c.argument_bytes}
        # the dry run's 1 x 1 train step against FlopCounterMode over the
        # plain step on real tensors (the check phase 16 makes on the card)
        from torch.utils.flop_counter import FlopCounterMode

        from repro_torch.models.weights import param_tree
        from repro_torch.train.train_step import make_train_step
        model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        ocfg = opt.AdamWConfig()
        state = opt.init(param_tree(model), ocfg)
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S),
                                         dtype=torch.int32)}
        with FlopCounterMode(display=False) as fc:
            make_train_step(cfg, ocfg)(model, state, batch)
        cost["plain|train"] = {"flops": fc.get_total_flops()}
    return {"placements": place, "cost": cost}


def mlp() -> dict:
    """x [B, d] (replicated) @ w1 [d, f] (columns over 'model') → relu →
    @ w2 [f, d] (rows over 'model'): one all-reduce of the [B, d]
    partial sums."""
    import torch
    from repro_torch.distributed import op_cost
    from repro_torch.distributed.sharding import (fake_world, named_mesh,
                                                  place)
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    Bm, d, f = 16, 64, 256
    with fake_world(2):
        mesh = named_mesh((1, 2), ("data", "model"), "cpu")
        with FakeTensorMode():
            x = place(torch.empty(Bm, d), (Replicate(), Replicate()), mesh,
                      local=True)
            w1 = place(torch.empty(d, f // 2), (Replicate(), Shard(1)), mesh,
                       local=True)
            w2 = place(torch.empty(f // 2, d), (Replicate(), Shard(0)), mesh,
                       local=True)

        def fwd(x, w1, w2):
            return (torch.relu(x @ w1) @ w2).redistribute(
                mesh, (Replicate(), Replicate()))
        c = op_cost.analyze(fwd, x, w1, w2)
    return {"collectives": c.collective_counts, "flops": c.flops,
            "expect_bytes": Bm * d * 4,
            "expect_flops": 2 * Bm * d * (f // 2) * 2}


def gloo() -> dict:
    """A real train step of reduced OLMo placed on a (1, 1) mesh of a
    one-rank gloo world against the plain step: loss and gradients."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import reduced
    from repro_torch.distributed.sharding import (DEFAULT_RULES,
                                                  logical_rules, named_mesh,
                                                  place, shardings_for)
    from repro_torch.launch.dryrun import port_layout
    from repro_torch.models import registry, transformer as tfm
    from repro_torch.models.common import logical_tree
    from repro_torch.models.weights import param_tree, tree_to_reference
    from torch.distributed.tensor.experimental import implicit_replication
    torch.manual_seed(0)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        cfg = reduced(registry.get_config("olmo-1b"))
        model = tfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        tokens = torch.randint(0, cfg.vocab, (4, 16), dtype=torch.int32)
        loss = registry.loss_fn(model, {"tokens": tokens})
        loss.backward()
        want = tree_to_reference(param_tree(model, grads=True))
        stacked = tree_to_reference(param_tree(model))
        mesh = named_mesh((1, 1), ("data", "model"), "cpu")
        with logical_rules(mesh, DEFAULT_RULES), implicit_replication():
            tree = _torch_tree(stacked)
            pl = shardings_for(tree, logical_tree(tfm.init_specs(cfg)))
            placed = _zip(lambda t, p: place(t, p, mesh), tree, pl)
            dmodel = tfm.Transformer(cfg, port_layout(cfg, placed))
            dmodel = _leafify(dmodel)
            tok = place(tokens, shardings_for(
                {"tokens": tokens}, {"tokens": ("batch", "seq")})["tokens"],
                mesh)
            dloss = registry.loss_fn(dmodel, {"tokens": tok})
            dloss.backward()
        got = tree_to_reference(_local_grads(param_tree(dmodel, grads=True)))
        same = all(_eq(got, want))
        return {"loss_equal": bool(torch.equal(dloss.full_tensor(), loss)),
                "grads_equal": same}
    finally:
        dist.destroy_process_group()


def exact(spec: str) -> dict:
    """The reference's exact cells on a ``spec["mesh"]`` mesh of 8 host
    devices: ``lower_search_sharded`` (``"sharded"``), ``lower_search_dtw``
    (``"dtw"`` with its order) and ``lower_search_degraded``
    (``"degraded"``) at ``spec``'s sizes, compiled.  For each cell:
    ``hlo_cost``'s FLOPs and unknown loops; each ``while`` loop outside the
    DTW DP's own (``dtw2_masked_*_jnp``, a kernel in the port) with its
    ``op_name`` and the trip count ``hlo_cost`` reads from its condition
    (None where it reads none and counts one trip); the collectives outside
    every loop and those inside one, as ``(kind, operand bytes, result
    type)``."""
    import re
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, str(ROOT / "src"))
    from repro.core import distributed as D
    from repro.distributed import hlo_cost
    from repro.distributed.sharding import logical_rules, make_mesh

    cfg = json.loads(spec)
    mesh = make_mesh(tuple(cfg.pop("mesh")), ("data", "model"))
    cells = cfg.pop("cells")
    called = re.compile(r"(?:calls|to_apply|body|condition|true_computation"
                        r"|false_computation)=(%[\w.\-]+)")
    out = {}
    for name, (kind, q_batch, order) in cells.items():
        kw = dict(cfg, q_batch=q_batch)
        with logical_rules(mesh):
            if kind == "dtw":
                low = D.lower_search_dtw(mesh, order=order, **kw)
            elif kind == "degraded":
                low = D.lower_search_degraded(mesh, **kw)
            else:
                low = D.lower_search_sharded(mesh, **kw)
            text = low.compile().as_text()
        cost = hlo_cost.analyze(text)
        blocks = hlo_cost.parse_blocks(text)
        in_loop: set = set()

        def mark(block):
            if block in in_loop or block not in blocks:
                return
            in_loop.add(block)
            for inst in blocks[block].instrs:
                for m in called.finditer(inst.line):
                    mark(m.group(1))

        loops = []
        for blk in blocks.values():
            for inst in blk.instrs:
                if inst.opcode != "while":
                    continue
                body = re.search(r"body=(%[\w.\-]+)", inst.line).group(1)
                cond = re.search(r"condition=(%[\w.\-]+)",
                                 inst.line).group(1)
                mark(body)
                mark(cond)
                op = re.search(r'op_name="([^"]*)"', inst.line).group(1)
                if "dtw2_masked" not in op:
                    loops.append({
                        "op": op.split("/", 1)[1],
                        "trips": hlo_cost._trip_count(blocks.get(cond))})
        coll = {"outside": [], "inside": []}
        for blk in blocks.values():
            for inst in blk.instrs:
                base = inst.opcode.replace("-start", "")
                if base not in hlo_cost._COLLECTIVES or \
                        inst.opcode.endswith("-done"):
                    continue
                nbytes = sum(hlo_cost._shape_elems_bytes(
                    blk.types.get(o, ""))[1] for o in inst.operands)
                where = "inside" if blk.name in in_loop else "outside"
                coll[where].append((base, nbytes, inst.result_type))
        out[name] = {"flops": cost.flops, "unknown_loops": cost.unknown_loops,
                     "loops": sorted(loops, key=lambda e: e["op"]),
                     "collectives": coll}
    return out


def _torch_tree(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(tree.copy())


def _zip(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _leafify(model):
    """Unit slices of placed stacked leaves are views: make each a leaf
    parameter of its own so every unit gets its own gradient."""
    import torch
    for mod in model.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            mod.register_parameter(name, torch.nn.Parameter(
                p.detach().clone()))
    return model


def _local_grads(tree):
    if isinstance(tree, dict):
        return {k: _local_grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_local_grads(v) for v in tree]
    return tree.full_tensor() if hasattr(tree, "full_tensor") else tree


def _eq(a, b):
    import numpy as np
    if isinstance(a, dict):
        for k in a:
            yield from _eq(a[k], b[k])
    else:
        yield bool(np.array_equal(a, b))


if __name__ == "__main__":
    out = {"ref": ref, "port": port, "mlp": mlp, "gloo": gloo,
           "exact": exact}[sys.argv[1]](*sys.argv[2:])
    print(json.dumps(out))
