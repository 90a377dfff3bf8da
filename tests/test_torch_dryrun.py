"""The dry run (``repro_torch.launch.dryrun``) and what it stands on:
``distributed.op_cost`` (per-device FLOPs, bytes and live memory on fake
tensors), ``distributed.op_analysis``, ``distributed.roofline`` (H100
peaks), the kernels' ``abstract`` functions and ``core.distributed``'s
``lower_*`` programs.

Everything is exact: hand-counted FLOPs and peaks, the kernel table's
Bound column (PERF.md, at its shapes) within its printed digits (1%),
the Dumpy cells' closed forms.  The CLI runs in a child process (it
starts a ``"fake"`` process group).
"""
import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.distributed import op_analysis, op_cost, roofline

ROOT = Path(__file__).resolve().parents[1]

# (kernel, its call at the kernel table's main shape, the table's Bound
# column in ms, what bounds it) — PERF.md's kernel table
KERNEL_BOUNDS = {
    "sax_encode": (lambda f: ((f(64, 256),), dict(w=16, b=8)),
                   0.0000223, "bytes"),
    "pairwise_l2": (lambda f: ((f(64, 256), f(2048, 256)), {}),
                    0.001026, "operations"),
    "lb_paa_interval": (lambda f: ((f(64, 16), f(64, 16), f(757, 16),
                                    f(757, 16)), dict(n=256)),
                        0.0000892, "bytes"),
    "lb_keogh": (lambda f: ((f(2048, 256), f(64, 256), f(64, 256)), {}),
                 0.003506, "operations"),
    "lb_improved": (lambda f: ((f(2048, 256), f(64, 256), f(64, 256),
                                f(64, 256)), dict(r=25)),
                    0.010016, "operations"),
}


def _fake(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype)


def _ops():
    from repro_torch.kernels import ops
    return ops


def test_five_chained_matmuls():
    with FakeTensorMode():
        a = _fake(256, 256)
        ws = [_fake(256, 256) for _ in range(5)]

    def chain(a, ws):
        for w in ws:
            a = a @ w
        return a
    cost = op_cost.analyze(chain, a, ws)
    assert cost.flops == 5 * 2 * 256 ** 3
    assert cost.flops_by_dtype == {"float32": 5 * 2 * 256 ** 3}
    assert cost.aten_ops == {"aten.mm.default": 5}
    assert cost.unknown_loops == 0 and cost.collective_bytes == 0
    # each product reads both operands and writes its result
    assert cost.hbm_bytes == 5 * 3 * 256 * 256 * 4


def test_peak_of_a_known_allocation_sequence():
    """Arguments 1 MiB; a (2 MiB) and b (3 MiB) live together, a dies, c
    (1 MiB) and d (4 MiB) live with b: peak 1 + 3 + 1 + 4 MiB; the output
    d (4 MiB) and the argument x returned too (an alias)."""
    MiB = 1 << 20
    with FakeTensorMode():
        x = torch.empty(MiB, dtype=torch.uint8)

    def prog(x):
        a = torch.empty(2 * MiB, dtype=torch.uint8)
        b = torch.empty(3 * MiB, dtype=torch.uint8)
        del a
        c = torch.empty(MiB, dtype=torch.uint8)
        d = torch.empty(4 * MiB, dtype=torch.uint8)
        del b, c
        return d, x
    cost = op_cost.analyze(prog, x)
    assert cost.argument_bytes == MiB
    assert cost.peak_bytes == (1 + 3 + 1 + 4) * MiB
    assert cost.output_bytes == 5 * MiB and cost.alias_bytes == MiB
    m = cost.memory()
    assert m["peak_per_device"] == m["argument_bytes"] + \
        m["output_bytes"] + m["temp_bytes"] - m["alias_bytes"]


def test_in_place_updates_alias_their_arguments():
    with FakeTensorMode():
        p = _fake(64, 64)
        g = _fake(64, 64)

    def step(p, g):
        p.sub_(0.1 * g)
        return p
    cost = op_cost.analyze(step, p, g)
    assert cost.alias_bytes == cost.output_bytes == 64 * 64 * 4


@pytest.mark.parametrize("name", sorted(KERNEL_BOUNDS))
def test_kernel_abstract_work_gives_the_table_bound(name):
    make, table_ms, by = KERNEL_BOUNDS[name]
    with FakeTensorMode():
        args, kw = make(_fake)
    cost = op_cost.analyze(
        lambda *a: getattr(_ops(), name)(*a, **kw), *args)
    k = cost.kernels[name]
    assert k["calls"] == 1
    s, got_by = roofline.kernel_bound_s(k["flops"], k["bytes"])
    assert s * 1e3 == pytest.approx(table_ms, rel=0.01)
    assert got_by == by
    assert cost.flops == k["flops"]


def test_dtw_band_abstract_work_is_every_lane_on():
    """Fake tensors hold no mask or cutoff: the work is the most a call
    could need, every lane through every in-band cell (the kernel table's
    bound formula at a call whose lanes are all on, none abandoned)."""
    Q, m, n, r = 2, 5, 2600, 2500
    with FakeTensorMode():
        qs, xs = _fake(Q, n), _fake(m, n)
        mask, cut = _fake(Q, m, dtype=torch.bool), _fake(Q)
    cost = op_cost.analyze(
        lambda *a: _ops().dtw_band(*a, r), qs, xs, mask, cut)
    cells = n * (2 * r + 1) - r * (r + 1)
    k = cost.kernels["dtw_band"]
    assert k["flops"] == 5 * Q * m * cells
    assert k["bytes"] == 4 * (Q * n + m * n + Q + Q * m) + Q * m


@pytest.mark.parametrize("name", ["sax_encode", "pairwise_l2", "lb_isax",
                                  "lb_keogh", "lb_improved", "dtw_band"])
def test_abstract_functions_refuse_real_tensors(name):
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    x = torch.ones(4, 16)
    args = {"sax_encode": (x, 4, 8), "pairwise_l2": (x, x),
            "lb_isax": (x[:, :4], x[:, :4], x[:, :4], x[:, :4], 16),
            "lb_keogh": (x, x, x), "lb_improved": (x, x, x, x, 2),
            "dtw_band": (x, x, torch.ones(4, 4, dtype=torch.bool),
                         torch.ones(4), 2)}[name]
    with pytest.raises(TypeError, match="fake tensors"):
        mod.abstract(*args)


def _small_mesh(shape=(4, 2), names=("data", "model")):
    return SimpleNamespace(mesh_dim_names=names, shape=shape)


def test_dumpy_search_cell_is_its_closed_form():
    from repro_torch.core import distributed as D
    N, n, w, L, Q, k = 1 << 14, 64, 16, 256, 8, 5
    mesh = _small_mesh()
    S = D._mesh_shards(mesh)
    assert S == 4
    cost = D.lower_search_oneshot(mesh, n_series=N, length=n, w=w,
                                  n_leaves=L, k=k, q_batch=Q,
                                  device="cpu").analyze()
    X = N // S
    assert cost.kernels == {
        "pairwise_l2": {"calls": 1,
                        "flops": 2 * Q * X * n + 2 * (Q + X) * n + 4 * Q * X,
                        "bytes": 4 * (Q * n + X * n + Q * X)},
        "lb_paa_interval": {"calls": 1, "flops": 7 * Q * L * w + Q * L,
                            "bytes": 4 * (2 * Q * w + 2 * L * w + Q * L)}}
    assert cost.collective_counts == {
        "all-gather": {"count": 1, "bytes": (S - 1) * Q * k * 8}}
    assert cost.flops == sum(v["flops"] for v in cost.kernels.values())
    assert cost.argument_bytes == 4 * (Q * n + X * n + 2 * L * w)


def test_dumpy_build_cell_is_its_closed_form():
    from repro_torch.core import distributed as D
    N, n, w, b = 1 << 12, 64, 8, 8
    mesh = _small_mesh((2, 4, 1), ("pod", "data", "model"))
    cost = D.lower_build_step(mesh, n_series=N, length=n, w=w, b=b,
                              device="cpu").analyze()
    X = N // 8
    assert cost.kernels == {"sax_encode": {
        "calls": 1, "flops": X * n + X * w + X * w * b,
        "bytes": 4 * (X * n + 2 * X * w + 255)}}
    assert cost.collective_counts == {
        "all-reduce": {"count": 1, "bytes": 8 * (1 << w)}}


@pytest.mark.parametrize("kind", ["search_extended", "search_approx",
                                  "search_bucket", "serving",
                                  "build_bottomup"])
def test_dumpy_index_cells_run_on_fake_tensors(kind):
    from repro_torch.core import distributed as D
    mesh = _small_mesh()
    kw = dict(n_series=1 << 14, length=64, w=16, device="cpu")
    lowered = {
        "search_extended": lambda: D.lower_search_extended(
            mesh, n_leaves=256, chunk=1024, **kw),
        "search_approx": lambda: D.lower_search_approx(
            mesh, n_leaves=256, chunk=1024, **kw),
        "search_bucket": lambda: D.lower_search_bucket(
            mesh, n_leaves=256, chunk=1024, **kw),
        "serving": lambda: D.lower_serving_head(
            mesh, vocab=4096, d_model=64, n_leaves=128, device="cpu"),
        "build_bottomup": lambda: D.lower_build_bottomup(
            mesh, n_series=1 << 14, w=16, device="cpu"),
    }[kind]()
    cost = lowered.analyze()
    assert cost.n_ops > 10 and cost.peak_bytes >= cost.argument_bytes > 0
    if kind == "build_bottomup":
        assert cost.collective_bytes == 0 and not cost.kernels
    else:
        assert cost.kernels["lb_paa_interval"]["calls"] >= 1
        assert cost.collective_counts["all-gather"]["count"] == 1
    if kind == "search_bucket":
        assert {"lb_keogh", "lb_improved", "dtw_band"} <= set(cost.kernels)


def test_roofline_terms_use_the_h100_peaks():
    rl = roofline.analyze(
        flops_per_device=989e12 + 67e12,
        flops_by_dtype={"bfloat16": 989e12, "float32": 67e12},
        bytes_per_device=3.35e12, collective_bytes_per_device=500e9,
        inter_host_bytes=50e9, n_devices=256, model_flops=1.0)
    assert rl.compute_s == pytest.approx(2.0)
    assert rl.memory_s == pytest.approx(1.0)
    assert rl.collective_s == pytest.approx(1.0 + 1.0)
    assert rl.bottleneck in ("compute", "collective") and rl.step_s == \
        pytest.approx(2.0)
    assert roofline.PEAK_FLOPS["tf32"] == 495e12
    assert roofline.PEAK_FLOPS["int8"] == 1979e12
    assert roofline.NIC_BW == 50e9 and roofline.NVLINK_BW == 450e9
    assert roofline.model_flops_estimate(10, 3, "train") == 180
    assert roofline.model_flops_estimate(10, 3, "decode") == 60


def test_op_analysis_censuses():
    cost = op_cost.OpCost(aten_ops={"aten.mm.default": 3,
                                    "aten.add.Tensor": 5},
                          dtypes={"float32": 8}, host_syncs={"Tensor.cpu": 1})
    cost.add_collective("all-gather", 64)
    cost.add_collective("all-gather", 32, inter_host=False)
    assert op_analysis.op_census(cost, top=1) == [("aten.add.Tensor", 5)]
    assert op_analysis.collective_stats(cost) == {
        "per_kind": {"all-gather": {"count": 2, "bytes": 96.0}},
        "total_bytes": 96.0}
    assert cost.inter_host_bytes == 64
    assert op_analysis.dtype_census(cost) == {"float32": 8}
    assert op_analysis.host_syncs(cost) == {"Tensor.cpu": 1}


def _reference_record_keys() -> set[str]:
    """The keys of the dict ``repro.launch.dryrun.lower_cell`` returns
    (read from its source: importing it starts JAX with 512 devices)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "lower_cell")
    rets = [n.value for n in ast.walk(fn) if isinstance(n, ast.Return)
            and isinstance(n.value, ast.Dict)]
    return {k.value for k in max(rets, key=lambda d: len(d.keys)).keys}


def test_cli_record_has_the_reference_keys(tmp_path):
    out = tmp_path / "dr"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "olmo-1b", "--shape", "decode_32k", "--mesh", "single", "--device",
         "cpu", "--out", str(out)], env=env, capture_output=True, text=True,
        timeout=600, cwd=str(ROOT))
    assert run.returncode == 0, run.stderr[-3000:]
    rec = json.loads((out / "olmo-1b__decode_32k__pod_16x16.json")
                     .read_text())
    want = _reference_record_keys() - {"cost_xla_raw"} | {"cost_raw"}
    assert set(rec) == want
    assert rec["n_devices"] == 256 and rec["tokens_per_step"] == 128
    m = rec["memory"]
    assert m["peak_per_device"] == m["argument_bytes"] + m["output_bytes"] \
        + m["temp_bytes"] - m["alias_bytes"]
    # the cache is written in place: it aliases, and counts once
    assert m["alias_bytes"] > 0
    assert rec["roofline"]["step_s"] > 0
    assert rec["cost"]["flops_per_device"] > 0
    from repro_torch.launch import summarize
    table = summarize.roofline_table([rec], "pod_16x16")
    assert "| olmo-1b | decode_32k |" in table
    assert "ERROR" not in summarize.dryrun_table([rec])


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.core.device_index import abstract_device_index
    from repro_torch.launch import dryrun
    from repro_torch.models import registry, transformer as tfm
    cfg = registry.get_config("olmo-1b")
    for call in (lambda: tfm.abstract_params(cfg),
                 lambda: abstract_device_index(1024, 64, 8),
                 lambda: dryrun.main(["--arch", "olmo-1b"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_abstract_trees_match_the_specs():
    from repro_torch.configs.base import SHAPES
    from repro_torch.models import registry, transformer as tfm
    from repro_torch.models.common import leaves, logical_tree
    from repro_torch.train import optimizer as opt
    cfg = registry.get_config("llama3-405b")
    p = tfm.abstract_params(cfg, "cpu")
    specs = tfm.init_specs(cfg)
    assert [tuple(t.shape) for t in leaves(p)] == \
        [s.shape for s in leaves(specs)]
    assert all(t.dtype == torch.bfloat16 for t in leaves(p))
    assert sum(t.numel() for t in leaves(p)) == tfm.count_params(cfg)
    st = opt.abstract_state(p, opt.AdamWConfig(moment_dtype="bfloat16"))
    assert st["step"].dtype == torch.int32 and st["m"]["embed"].dtype == \
        torch.bfloat16
    b = registry.input_specs(cfg, SHAPES["decode_32k"], "cpu")
    assert b["token"].shape == (128, 1) and b["pos"].dtype == torch.int32
    lg = registry.batch_logical(cfg, SHAPES["decode_32k"])
    assert lg["cache"]["stack"]["b0"]["k"] == ("layers", "batch",
                                               "cache_seq", "kv", None)
    assert logical_tree(specs)["embed"] == ("vocab", "embed_fsdp")
    assert math.prod(b["cache"]["stack"]["b0"]["k"].shape) > 1e9
