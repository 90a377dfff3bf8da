"""The port stands alone: it imports neither ``jax`` nor ``repro``, and its
entry points run on CUDA unless the caller asks for the CPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _torch_port import build_pair, torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_jax_or_reference_imports_in_the_port():
    files = _port_files()
    assert len(files) > 15
    for path in files:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.core.search_device, repro_torch.kernels.ops\n"
        "import repro_torch.core.device_index, repro_torch.data.series\n"
        "import repro_torch.serving.batching, repro_torch.serving.knn_softmax\n"
        "import repro_torch.core.build_device, repro_torch.robustness.wal\n"
        "import repro_torch.robustness.smoke\n"
        "import repro_torch.core.distributed, repro_torch.distributed.sharding\n"
        "import repro_torch.core.baselines.brute\n"
        "import repro_torch.core.baselines.dstree\n"
        "import repro_torch.core.baselines.isax2plus\n"
        "import repro_torch.core.baselines.tardis\n"
        "import repro_torch.analysis.lint, repro_torch.analysis.audit\n"
        "import repro_torch.analysis.contracts\n"
        "import repro_torch.analysis.recompile\n"
        "import repro_torch.analysis.registry, repro_torch.analysis.guards\n"
        "import repro_torch.configs.base, repro_torch.models.registry\n"
        "import repro_torch.models.common, repro_torch.models.moe\n"
        "import repro_torch.models.griffin, repro_torch.models.xlstm\n"
        "import repro_torch.models.transformer, repro_torch.models.weights\n"
        "import repro_torch.data.tokens\n"
        "import repro_torch.train.optimizer, repro_torch.train.grad_compress\n"
        "import repro_torch.train.train_step, repro_torch.train.checkpoint\n"
        "import repro_torch.train.trainer\n"
        "import repro_torch.launch.mesh, repro_torch.launch.train\n"
        "import repro_torch.launch.serve, repro_torch.launch.summarize\n"
        "import repro_torch.launch.dryrun, repro_torch.distributed.roofline\n"
        "import repro_torch.distributed.op_cost\n"
        "import repro_torch.distributed.op_analysis\n"
        "from repro_torch.launch.mesh import World, make_rank_mesh, world\n"
        "from repro_torch.models.weights import logical_names, place_model\n"
        "from repro_torch.distributed.sharding import (counted_here,\n"
        "    local_chunk, place_rows)\n"
        "from repro_torch.models.registry import ARCH_NAMES, get_config\n"
        "[get_config(n) for n in ARCH_NAMES]   # every config module\n"
        "from repro_torch.data.series import (clustered_series,\n"
        "    cluster_assignment)\n"
        "x = clustered_series(300, 16, n_clusters=8)\n"
        "assert x.shape == (300, 16) and len(cluster_assignment(300, 8)) == 300\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from repro.data.series import random_walks
    from repro_torch.core.device_index import DeviceIndex
    from repro_torch.core.search_device import (exact_search_device,
                                                exact_search_device_batch)
    _, pi = build_pair(random_walks(300, 64, seed=0))
    qs = random_walks(2, 64, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exact_search_device_batch(pi, qs, 5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exact_search_device(pi, qs[0], 5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pi.device_index()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceIndex.from_index(pi)
    assert pi._n_device_builds == 0        # nothing ran on the CPU instead


def test_approx_and_extended_default_to_cuda_and_raise_without_it(no_cuda):
    from repro.data.series import random_walks
    from repro_torch.core.search_device import (
        approximate_search_device_batch, extended_search_device_batch)
    _, pi = build_pair(random_walks(300, 64, seed=0))
    qs = random_walks(2, 64, seed=1)
    for search in (approximate_search_device_batch,
                   extended_search_device_batch):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            search(pi, qs, 5)
    assert pi._n_device_builds == 0        # nothing ran on the CPU instead


def test_model_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from repro_torch.configs.base import reduced
    from repro_torch.models import registry, transformer as tfm, weights
    cfg = reduced(registry.get_config("olmo-1b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfm.init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        weights.model_from_reference(cfg, {})


def test_chip_smoke_fails_alone_and_without_cuda(no_cuda, tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (tmp_path, ROOT):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
