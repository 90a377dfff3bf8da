"""Child processes of the multi-rank training tests
(``tests/test_torch_train_mesh.py``, ``tests/test_torch_launch.py``,
``tests/test_torch_train_float64.py``).

    python tests/_torch_mesh_children.py <job> <rank> <size> <store> [args]
    torchrun --standalone --nproc-per-node N tests/_torch_mesh_children.py \\
        train <npz or -> <sigterm rank:step or -> [launch.train arguments]
    python tests/_torch_mesh_children.py refstep <out>
    torchrun --nnodes 2 --node-rank H ... tests/_torch_mesh_children.py \
        tokens <out> <batch> <seq> <vocab>

The rank jobs join a gloo group of ``size`` ranks through the ``file://``
store ``store`` and print one JSON object as their last line: ``elastic``
(restores across mesh sizes), ``step`` (a placed step on three meshes, a
checkpoint saved by the ranks, the tokens each rank makes), ``float64``
(the placed float64 step on three meshes under a census of its ops).
``train`` is ``repro_torch.launch.train.main`` under ``torchrun``, its
model built from the reference's parameters in an ``.npz`` (``-``: its
own seed-0 parameters), and a rank that sends itself SIGTERM while the
data of a step is drawn.  ``refstep`` is the reference's loss and gradients, jitted with
the placements of each mesh on 4 host devices.  ``tokens`` is one gloo
rank under ``torchrun``, which writes the rows it draws.  No child ends
another process; files go where the test says.
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((2, 2), (1, 4), (4, 1))
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=50)
B, S = 4, 32
# the float64 step's cases: reduced OLMo-1B overrides, batch, sequence;
# "wide" has the full preset's remat and sequence-sharded residual
CASES64 = {"smoke": ({}, B, S),
           "wide": (dict(d_model=256, n_layers=2, head_dim=64, d_ff=1024,
                         vocab=2048, remat="full", act_shard="seq"), 8, 64)}


def flat(tree, prefix=""):
    """A nested dict of arrays as ``{"a/b": array}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflat(d) -> dict:
    out: dict = {}
    for key, v in d.items():
        *path, last = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _join(rank: int, size: int, store: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=size)


def _whole(tree):
    from repro_torch.models.common import map_tree
    return map_tree(lambda t: t.full_tensor() if hasattr(t, "full_tensor")
                    else t, tree)


def elastic(rank: int, size: int, store: str, root: str) -> dict:
    """Eight ranks: restore ``root/one`` (written by one process) on an
    (8,) ``data`` mesh and save it from the ranks into ``root/eight``;
    place a tree on (2, 4), save it into ``root/24`` and restore it on
    (4, 2).  Each restore reports whether every rank's local shard equals
    its slice of the whole tensor and the whole tensor the one written,
    bitwise."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.sharding import (DEFAULT_RULES,
                                                  local_chunk, logical_rules,
                                                  named_mesh, place)
    from repro_torch.train.checkpoint import CheckpointManager
    _join(rank, size, store)
    out = {}
    try:
        one = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
               "b": torch.ones(16)}

        def check(tree, want, pls, mesh):
            ok = True
            for k in want:
                t = tree[k]
                ok &= tuple(t.placements) == tuple(pls[k])
                ok &= torch.equal(t.to_local(),
                                  local_chunk(want[k], pls[k], mesh))
                ok &= torch.equal(t.full_tensor(), want[k])
                ok &= t.full_tensor().dtype == want[k].dtype
            return bool(ok)

        mesh = named_mesh((8,), ("data",), "cpu")
        pls = {"w": (Shard(0),), "b": (Shard(0),)}
        with logical_rules(mesh, DEFAULT_RULES):
            tree, extras = CheckpointManager(f"{root}/one").restore(
                5, {k: torch.zeros_like(v) for k, v in one.items()},
                sharding_fn=lambda t: pls)
        out["1to8"] = check(tree, one, pls, mesh) and extras == {
            "next_step": 5}
        CheckpointManager(f"{root}/eight").save(6, tree,
                                                extras={"next_step": 6})

        g = torch.Generator().manual_seed(1)
        mixed = {"w": torch.randn(8, 12, generator=g),
                 "h": torch.randn(4, 6, generator=g).to(torch.bfloat16),
                 "s": torch.tensor(7, dtype=torch.int32)}
        rep = (Replicate(), Replicate())
        m24 = named_mesh((2, 4), ("data", "model"), "cpu")
        p24 = {"w": (Shard(0), Shard(1)), "h": (Replicate(), Shard(0)),
               "s": rep}
        with logical_rules(m24, DEFAULT_RULES):
            placed = {k: place(v, p24[k], m24) for k, v in mixed.items()}
            CheckpointManager(f"{root}/24").save(3, placed,
                                                 extras={"next_step": 3})
        m42 = named_mesh((4, 2), ("data", "model"), "cpu")
        p42 = {"w": (Shard(1), Shard(0)), "h": (Shard(0), Replicate()),
               "s": rep}
        with logical_rules(m42, DEFAULT_RULES):
            tree, _ = CheckpointManager(f"{root}/24").restore(
                3, {k: torch.zeros_like(v) for k, v in mixed.items()},
                sharding_fn=lambda t: p42)
        out["24to42"] = check(tree, mixed, p42, m42)
        out["files"] = sorted(os.listdir(root))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def step(rank: int, size: int, store: str, npz: str, out_dir: str) -> dict:
    """Four ranks on the reference's parameters (``npz``): on each of
    :data:`SHAPES` the placed model's loss and gradients on
    ``batch_at(0)`` (rank 0 writes them whole into ``out_dir/<mesh>.npz``);
    on (2, 2) one train step and a checkpoint of its state saved by the
    ranks into ``out_dir/ckpt`` (rank 0 writes the same values whole into
    ``out_dir/state.npz``); and the tokens of ``batch_at(3)`` on one host
    of four ranks and on two hosts of two (``LOCAL_WORLD_SIZE``)."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs.base import reduced
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.distributed.sharding import (DEFAULT_RULES,
                                                  logical_rules, named_mesh)
    from repro_torch.models import registry, weights
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.checkpoint import CheckpointManager
    _join(rank, size, store)
    out = {}
    try:
        cfg = reduced(registry.get_config("olmo-1b"))
        tree = unflat(dict(np.load(npz)))
        pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=S,
                                                 global_batch=B))
        for shape in SHAPES:
            name = f"{shape[0]}x{shape[1]}"
            mesh = named_mesh(shape, ("data", "model"), "cpu")
            with logical_rules(mesh, DEFAULT_RULES):
                model = weights.place_model(
                    weights.model_from_reference(cfg, tree, "cpu"))
                batch = ts._model_batch(model, pipe.batch_at(0))
                loss, grads = ts._loss_and_grads(model, batch)
                whole = weights.tree_to_reference(_whole(grads))
                local_rows = batch["tokens"].to_local().shape[0]
                if name == "2x2":
                    ocfg = opt.AdamWConfig(**OCFG)
                    state = opt.init(weights.param_tree(model), ocfg)
                    model, state, m = ts.make_train_step(cfg, ocfg)(
                        model, state, pipe.batch_at(0))
                    CheckpointManager(f"{out_dir}/ckpt").save(
                        1, (weights.param_tree(model), state),
                        extras={"next_step": 1})
                    params = weights.tree_to_reference(
                        _whole(weights.param_tree(model)))
                    st = {k: weights.tree_to_reference(_whole(state[k]))
                          for k in ("m", "v")}
                    if rank == 0:
                        np.savez(f"{out_dir}/state.npz", **{
                            f"0/{k}": v for k, v in flat(params).items()},
                            **{f"1/{k}": v for k, v in flat(st).items()},
                            step=int(state["step"]),
                            grad_norm=float(m["grad_norm"]))
            if rank == 0:
                np.savez(f"{out_dir}/{name}.npz", loss=float(loss),
                         **flat(whole))
            out[name] = {"local_rows": local_rows}
        out["tokens"] = pipe.batch_at(3)["tokens"].tolist()
        os.environ["LOCAL_WORLD_SIZE"] = "2"
        try:
            out["tokens_2hosts"] = pipe.batch_at(3)["tokens"].tolist()
        finally:
            del os.environ["LOCAL_WORLD_SIZE"]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def script():
    """``scripts/train_over_cards.py`` as a module."""
    import importlib.util
    name = "train_over_cards"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "scripts" / f"{name}.py")
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


def float64_model(case: str, mesh=None):
    """Case ``case`` of :data:`CASES64` in float64, as
    ``scripts/train_over_cards.py`` builds its float64 step (``copy_as``):
    the seed-0 float32 model, placed where a ``mesh`` is given, copied
    with ``param_dtype`` and ``compute_dtype`` ``"float64"``.  Returns the
    model and its batch ``batch_at(0)`` (numpy)."""
    import torch
    from repro_torch.configs.base import reduced
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.models import registry, transformer as tfm
    from repro_torch.models.weights import place_model
    over, batch, seq = CASES64[case]
    cfg = reduced(registry.get_config("olmo-1b"), **over)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if mesh is not None:
        model = place_model(model)
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=seq,
                                             global_batch=batch))
    return script().copy_as(model, param_dtype="float64",
                            compute_dtype="float64"), pipe.batch_at(0)


def census():
    """A ``TorchDispatchMode`` that counts the ops it sees (``.ops``) and,
    by op, the floating outputs that are not float64 (``.found``)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Census(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.found: dict = {}
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops += 1
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point() \
                        and t.dtype != torch.float64:
                    key = f"{func} -> {t.dtype}"
                    self.found[key] = self.found.get(key, 0) + 1
            return out
    return Census()


def float64(rank: int, size: int, store: str, out_dir: str) -> dict:
    """Four ranks: on each of :data:`SHAPES` and each case of
    :data:`CASES64`, the placed float64 first step
    (``train_step._loss_and_grads``, the bf16 roundings the script's
    ``Unrounded``) under :func:`census`; rank 0 writes the loss and the gradients whole into
    ``out_dir/<case>_<mesh>.npz``.  Reports each step's census."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.distributed.sharding import (DEFAULT_RULES,
                                                  logical_rules, named_mesh)
    from repro_torch.models import common, weights
    from repro_torch.train import train_step as ts
    _join(rank, size, store)
    common._RoundBF16 = common._GradRoundBF16 = script().Unrounded
    out = {}
    try:
        for case in CASES64:
            for shape in SHAPES:
                name = f"{case}_{shape[0]}x{shape[1]}"
                mesh = named_mesh(shape, ("data", "model"), "cpu")
                with logical_rules(mesh, DEFAULT_RULES):
                    model, batch = float64_model(case, mesh)
                    batch = ts._model_batch(model, batch)
                    with census() as seen:
                        loss, grads = ts._loss_and_grads(model, batch)
                    whole = weights.tree_to_reference(_whole(grads))
                if rank == 0:
                    np.savez(f"{out_dir}/{name}.npz", loss=float(loss),
                             **flat(whole))
                out[name] = {"census": seen.found, "ops": seen.ops,
                             "dtype": str(loss.dtype)}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def refstep(out_dir: str) -> None:
    """The reference's loss and gradients on ``batch_at(0)`` of its seed-0
    reduced OLMo, jitted with the placements of each of :data:`SHAPES`
    (``shardings_for`` under ``DEFAULT_RULES``) on 4 host devices, into
    ``out_dir/ref_<mesh>.npz``; the reference's tokens of ``batch_at(3)``
    as two processes make them into ``out_dir/ref_tokens.npz``."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import numpy as np
    from repro.configs.base import reduced
    from repro.data import tokens as r_tokens
    from repro.distributed.sharding import (DEFAULT_RULES, logical_rules,
                                            make_mesh, shardings_for)
    from repro.models import registry, transformer as tfm
    from repro.models.common import logical_tree
    cfg = reduced(registry.get_config("olmo-1b"))
    params = tfm.init_params(cfg, jax.random.PRNGKey(0))
    pipe = r_tokens.TokenPipeline(r_tokens.TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B))
    batch = pipe.batch_at(0)
    for shape in SHAPES:
        mesh = make_mesh(shape, ("data", "model"))
        with logical_rules(mesh, DEFAULT_RULES):
            psh = shardings_for(tfm.abstract_params(cfg),
                                logical_tree(tfm.init_specs(cfg)))
            bsh = shardings_for(
                {"tokens": jax.ShapeDtypeStruct((B, S), np.int32)},
                {"tokens": ("batch", "seq")})
            f = jax.jit(jax.value_and_grad(
                lambda p, b: registry.loss_fn(p, b, cfg)),
                in_shardings=(psh, bsh))
            loss, grads = f(params, batch)
        np.savez(f"{out_dir}/ref_{shape[0]}x{shape[1]}.npz",
                 loss=float(loss),
                 **flat(jax.tree.map(np.asarray, grads)))
    toks = {}
    for pid in (0, 1):
        jax.process_index, jax.process_count = (lambda: pid), (lambda: 2)
        toks[str(pid)] = pipe.batch_at(3)["tokens"]
    np.savez(f"{out_dir}/ref_tokens.npz", **toks)


def train(npz: str, sigterm: str, argv: list[str]) -> None:
    """``launch.train.main(argv)`` on this ``torchrun`` rank, its model
    the reference's parameters from ``npz`` (unless ``-``); with
    ``sigterm`` ``"<rank>:<step>"`` (``*`` for every rank), that rank
    sends itself SIGTERM while the data of that step is drawn."""
    import signal

    import numpy as np
    import torch
    from repro_torch.data import tokens
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as tfm, weights
    torch.set_num_threads(1)
    if npz != "-":
        tree = unflat(dict(np.load(npz)))
        tfm.init_params = lambda cfg, gen, device: \
            weights.model_from_reference(cfg, tree, device)
    if sigterm != "-":
        who, at = sigterm.split(":")
        batch_at = tokens.TokenPipeline.batch_at

        def drawn(self, step):
            if int(step) == int(at) and who in ("*", os.environ["RANK"]):
                os.kill(os.getpid(), signal.SIGTERM)   # preemption, to itself
            return batch_at(self, step)
        tokens.TokenPipeline.batch_at = drawn
    launch_train.main(argv)


def tokens(out_dir: str, batch: int, seq: int, vocab: int) -> None:
    """This ``torchrun`` rank in a gloo group: its host's rows of
    ``batch_at(0)`` and ``batch_at(1)`` into ``out_dir/rank<RANK>.npz``."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    dist.init_process_group("gloo")
    try:
        pipe = TokenPipeline(TokenPipelineConfig(vocab=vocab, seq_len=seq,
                                                 global_batch=batch))
        np.savez(f"{out_dir}/rank{dist.get_rank()}.npz",
                 **{f"step{s}": pipe.batch_at(s)["tokens"] for s in (0, 1)})
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    job = sys.argv[1]
    if job == "refstep":
        refstep(sys.argv[2])
    elif job == "tokens":
        tokens(sys.argv[2], *map(int, sys.argv[3:6]))
    elif job == "train":
        train(sys.argv[2], sys.argv[3], sys.argv[4:])
    else:
        fn = {"elastic": elastic, "step": step, "float64": float64}[job]
        res = fn(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                 *sys.argv[5:])
        print(json.dumps(res))
