"""Placement of model tensors on a named mesh, against the reference.

The reference computes each leaf's ``PartitionSpec`` with 8 fake XLA host
devices, and its per-device FLOPs (``hlo_cost``) and argument bytes
(``memory_analysis``) of reduced OLMo's train, prefill and decode steps;
the port computes the same on a ``"fake"`` process group of 8 ranks
(``sharding.fake_world``) with ``op_cost``.  Each side runs in a child
process (``tests/_torch_dryrun_children.py``): the reference needs its
device count before JAX starts, and the port's group must not outlive
its job.

Tolerances: placements and argument bytes exact; FLOPs within 1% on a
(1, 1) mesh and within 10% on (4, 2) (the two programs are partitioned by
different compilers: the reference's GSPMD and DTensor's propagation);
the dry run's (1, 1) train step exactly ``FlopCounterMode``'s count over
the plain step on real tensors.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CHILD = ROOT / "tests" / "_torch_dryrun_children.py"
ARCHS = ("whisper-base", "llama4-scout-17b-a16e", "phi3.5-moe-42b-a6.6b",
         "mistral-nemo-12b", "llama3-405b", "olmo-1b", "qwen3-32b",
         "xlstm-1.3b", "recurrentgemma-9b", "llama-3.2-vision-90b")


def _child(job: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, str(CHILD), job], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def both():
    return _child("ref"), _child("port")


def test_arch_list_is_the_registry():
    from repro_torch.models.registry import ARCH_NAMES
    assert tuple(ARCH_NAMES) == ARCHS


@pytest.mark.parametrize("mesh", ["4x2", "2x2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_equal_the_reference(both, arch, mesh):
    ref, port = both
    want = ref["placements"][f"{arch}|{mesh}"]
    got = port["placements"][f"{arch}|{mesh}"]
    assert sorted(got) == sorted(want)
    assert len(want) > 10
    bad = {leaf: (got[leaf], want[leaf]) for leaf in want
           if got[leaf] != want[leaf]}
    assert not bad


@pytest.mark.parametrize("mesh", ["1x1", "4x2"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_argument_bytes_equal_the_reference(both, kind, mesh):
    ref, port = both
    key = f"{mesh}|{kind}"
    assert port["cost"][key]["argument_bytes"] == \
        ref["cost"][key]["argument_bytes"]


@pytest.mark.parametrize("mesh,rel", [("1x1", 0.01), ("4x2", 0.10)])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_per_device_flops_near_the_reference(both, kind, mesh, rel):
    ref, port = both
    key = f"{mesh}|{kind}"
    assert port["cost"][key]["flops"] == pytest.approx(
        ref["cost"][key]["flops"], rel=rel)


def test_one_device_flops_equal_flop_counter_over_the_plain_step(both):
    _, port = both
    assert port["cost"]["1x1|train"]["flops"] == \
        port["cost"]["plain|train"]["flops"]


def test_sharded_mlp_makes_one_all_reduce():
    """Columns then rows over 'model' on (1, 2): one all-reduce of the
    [B, d] float32 partial sums a device, and half the products."""
    rec = _child("mlp")
    assert rec["collectives"] == {"all-reduce": {
        "count": 1, "bytes": float(rec["expect_bytes"])}}
    assert rec["flops"] == rec["expect_flops"]


def test_placed_step_on_a_gloo_mesh_is_bitwise_the_plain_step():
    rec = _child("gloo")
    assert rec == {"loss_equal": True, "grads_equal": True}


def test_rules_without_a_device_mesh():
    import torch
    from repro_torch.distributed.sharding import (DEFAULT_RULES, divisible,
                                                  get_device_mesh, like,
                                                  logical_rules,
                                                  named_sharding, shard)
    x = torch.ones(3, 5)
    with logical_rules(("data", "model"), DEFAULT_RULES):
        assert get_device_mesh() is None
        assert named_sharding(("batch", None)) is None
        assert divisible(3, ("heads",), 0)
        assert like(x, x) is x
    assert shard(x, "batch", None) is x
    assert divisible(7, ("heads",), 0)


def test_placements_and_divisibility_fallback():
    from types import SimpleNamespace

    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import (divisible_spec,
                                                  local_shape, placements,
                                                  spec_of)
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                           shape=(2, 4, 16), ndim=3)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec = (("pod", "data"), "model")
    pl = placements(spec, mesh)
    assert pl == (Shard(0), Shard(0), Shard(1))
    assert spec_of(pl, mesh, 2) == spec
    assert local_shape((16, 64), pl, mesh) == (2, 4)
    # whisper's 51 865-entry vocabulary does not divide 16: replicated
    assert divisible_spec((None, "model"), (512, 51_865), sizes) == \
        (None, None)
    assert placements((None, None), mesh) == (Replicate(),) * 3
