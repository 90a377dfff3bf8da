"""The port's AST linter (``repro_torch.analysis.lint``): each rule fires on
a minimal torch snippet and stays quiet on its idiomatic fix — the eager
twins of every JX001, JX004, JX005 and JX006 case of
``tests/test_analysis_lint.py`` — and the tree itself is clean."""
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis.lint import (count_suppressions, default_paths,
                                       lint_paths, lint_source)

ROOT = Path(__file__).resolve().parents[1]
#: snippets lint as a module of the search package (TX001's scope)
CORE = "src/repro_torch/core/snippet.py"


def _rules(src: str, path: str = CORE) -> list[str]:
    return [f.rule for f in lint_source(src, path)]


# ---------------------------------------------------------------------------
# TX001: the twins of JX001 (host control flow on a device value)
# ---------------------------------------------------------------------------

# (flagged form, clean form) per reference case
TX001_CASES = {
    # test_if_on_tracer_flagged: `if x:` → an `if` on a device reduction
    "if_on_device_value": ("""
import torch
def f(xs: list[torch.Tensor]):
    for x in xs:
        if x.any():
            return x
""", """
import torch
def f(xs: list[torch.Tensor]):
    for x in xs:
        x = torch.where(x > 0, x, -x)
    return xs
"""),
    # test_while_on_tracer_flagged_through_partial: `while x:`
    "while_on_device_value": ("""
import torch
def f(x: torch.Tensor, n: int):
    while (x > 0).any():
        x = x - n
    return x
""", """
import torch
def f(x: torch.Tensor, n: int):
    for _ in range(n):
        x = torch.clamp_min(x - 1, 0)
    return x
"""),
    # test_static_argnums_positions_resolve: `if n > 2` is host, `if x`
    # is device
    "host_int_vs_device_bool": ("""
import torch
def f(x: torch.Tensor, n: int):
    for i in range(n):
        if n > 2 and bool(x[i]):
            return x
""", """
import torch
def f(x: torch.Tensor, n: int):
    for i in range(n):
        if n > 2 and i % 2:
            x = x + 1
    return x
"""),
    # test_concretization_and_len_flagged (JX004): float() on a device value
    "float_of_device_value": ("""
import torch
def f(xs: list[torch.Tensor]):
    out = 0.0
    for x in xs:
        out += float(x.sum())
    return out
""", """
import torch
def f(xs: list[torch.Tensor]):
    out = torch.zeros(())
    for x in xs:
        out += x.sum()
    return out
"""),
    # test_concretization_and_len_flagged (JX005): a data-dependent size
    # read on the host
    "size_read_on_the_host": ("""
import torch
def f(xs: list[torch.Tensor], mask: torch.Tensor):
    for x in xs:
        n = int(mask.sum())
        x = x[:n]
    return xs
""", """
import torch
def f(xs: list[torch.Tensor], mask: torch.Tensor):
    for x in xs:
        n = mask.shape[0]
        x = x[:n]
    return xs
"""),
    # .item() / .tolist() / .cpu() / .numpy() per iteration
    "item_per_step": ("""
import torch
def f(xs: list[torch.Tensor]):
    return [x.max().item() for x in xs]
""", """
import torch
def f(xs: list[torch.Tensor]):
    return torch.stack([x.max() for x in xs]).cpu()
"""),
}


@pytest.mark.parametrize("case", sorted(TX001_CASES))
def test_tx001_flags_the_sync_and_not_its_fix(case):
    bad, good = TX001_CASES[case]
    assert set(_rules(bad)) == {"TX001"}
    assert _rules(good) == []


def test_static_attributes_and_none_tests_not_flagged():
    """Twin of ``test_static_args_and_attributes_not_flagged``: shapes,
    ``dev.chunk``-style metadata and ``is None`` tests are host values."""
    src = """
import torch
def f(dev, qs, mask, k):
    for i in range(k):
        if k > 3:
            pass
        if dev.chunk > qs.shape[0]:
            pass
        if mask is not None:
            pass
        n = len(qs)
    return qs
"""
    assert _rules(src) == []


def test_sync_outside_a_loop_or_scope_not_flagged():
    """Twin of ``test_unjitted_function_ignored``: one read after the loop
    is the result's download; outside ``core/``, ``serving/`` and
    ``kernels/``, in a module without torch, or in a function that names
    neither ``torch`` nor ``ops`` (host code) nothing is checked."""
    once = """
import torch
def f(xs: list[torch.Tensor]):
    for x in xs:
        x.add_(1)
    return xs[0].cpu().numpy()
"""
    assert _rules(once) == []
    loop = """
import torch
def f(xs: list[torch.Tensor]):
    return [float(x.sum()) for x in xs]
"""
    assert _rules(loop, "src/repro_torch/robustness/x.py") == []
    assert _rules(loop.replace("import torch", "import numpy"), CORE) == []
    assert _rules("""
import torch
def f(rows):
    return [int(r) for r in rows]
""") == []


def test_loop_iterable_is_read_once():
    """``for v in t.cpu()`` downloads once, before the loop; the body's
    ``int(v)`` is still a per-step read."""
    assert _rules("""
import torch
def f(t: torch.Tensor):
    for v in t.cpu():
        pass
""") == []
    assert _rules("""
import torch
def f(t: torch.Tensor):
    return [int(v) for v in t.cpu()]
""") == ["TX001"]


def test_suppression_needs_a_reason():
    bad = """
import torch
def f(x: torch.Tensor, n: int):
    for i in range(n):
        if not bool(x.any()):  # lint: allow-sync
            break
"""
    found = lint_source(bad, CORE)
    assert [f.rule for f in found] == ["TX001"]
    assert "without a reason" in found[0].message
    ok = bad.replace("# lint: allow-sync",
                     "# lint: allow-sync: the stop test")
    assert _rules(ok) == []


def test_suppression_in_a_string_is_not_a_comment():
    src = '''
import torch
def f(x: torch.Tensor, n: int):
    for i in range(n):
        if bool(x.any()): s = "# lint: allow-sync: not a comment"
'''
    assert "TX001" in _rules(src)


# ---------------------------------------------------------------------------
# TX006: the twins of the JX006 cases
# ---------------------------------------------------------------------------

OLD_TIME = """
import time
def _time(fn, repeat=3):
    fn()
    t0 = time.perf_counter()
    for _ in range(repeat):
        fn()
    return (time.perf_counter() - t0) / repeat
"""

FIXED_TIME = """
import time, torch
def _time(fn, repeat=3):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeat):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / repeat
"""

EVENT_TIME = """
import time, torch
def _time(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record(); fn(); end.record()
    host = time.perf_counter() - t0
    end.synchronize()
    return start.elapsed_time(end), host
"""


def test_unsynced_timing_window_flagged():
    assert _rules(OLD_TIME, "chip_smoke.py") == ["TX006"]


@pytest.mark.parametrize("src", [FIXED_TIME, EVENT_TIME,
                                 OLD_TIME.replace("    fn()\n    return",
                                                  "    fn().item()\n    return")],
                         ids=["synchronize", "events", "device_read"])
def test_synced_timing_window_ok(src):
    assert _rules(src, "chip_smoke.py") == []


def test_timing_suppression_comment():
    src = OLD_TIME.replace(
        "    t0 = time.perf_counter()",
        "    # lint: allow-timing: host-only window\n"
        "    t0 = time.perf_counter()", 1)
    assert _rules(src, "chip_smoke.py") == []


def test_single_perf_counter_not_a_window():
    assert _rules("""
import time
def stamp():
    return time.perf_counter()
""", "chip_smoke.py") == []


# ---------------------------------------------------------------------------
# the tree itself is clean, and the CLI says how many suppressions it holds
# ---------------------------------------------------------------------------

def test_port_tree_is_lint_clean():
    findings = lint_paths(default_paths())
    assert findings == [], "\n".join(map(str, findings))
    assert count_suppressions(default_paths()) > 0


def test_cli_prints_the_suppression_count(tmp_path):
    bad = tmp_path / "core" / "bad.py"
    bad.parent.mkdir()
    bad.write_text(TX001_CASES["item_per_step"][0])
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", str(bad)],
        capture_output=True, text=True, cwd=ROOT, timeout=60,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 1
    assert "TX001" in out.stdout and "0 suppression(s)" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint"],
        capture_output=True, text=True, cwd=ROOT, timeout=60,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout
    n = count_suppressions(default_paths())
    assert f"0 finding(s), {n} suppression(s)" in out.stdout


def test_importing_the_analysis_package_loads_nothing_else():
    """The package imports neither ``jax`` nor ``repro``, and importing it
    initialises no CUDA and builds no kernel."""
    code = (
        "import sys, torch\n"
        "import repro_torch.analysis\n"
        "assert len([m for m in sys.modules if m.startswith('repro_torch')])"
        " == 2, sorted(sys.modules)\n"
        "import repro_torch.analysis.lint, repro_torch.analysis.contracts\n"
        "import repro_torch.analysis.registry, repro_torch.analysis.audit\n"
        "import repro_torch.analysis.recompile, repro_torch.analysis.guards\n"
        "from repro_torch.kernels import _build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized() and _build._lib is None\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
