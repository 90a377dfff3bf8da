"""AST linter for the port's eager-torch hazards (port of
``repro.analysis.lint``).

Pure ``ast`` (no torch import, no code execution), so it runs in
milliseconds over the whole tree.

Rules
-----
* **TX001** (the eager twin of JX001, JX004 and JX005) — an implicit
  device→host sync inside the body of a ``for`` or ``while`` loop in
  ``core/``, ``serving/`` or ``kernels/``: ``bool()``, ``int()`` or
  ``float()`` on a non-literal, ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, or an ``if`` / ``while`` test built from ``.any()`` or
  ``.all()``.  In eager PyTorch each of these waits for the device once per
  iteration: where a jitted program would fail to trace, an eager loop
  silently serializes host and device.  The reads that sync on purpose (a
  stop test every ``STOP_CHECK_EVERY`` steps, a read of a host array)
  carry ``# lint: allow-sync: <reason>`` on the line; a suppression with
  no reason is itself a finding.  Only functions that name ``torch`` or
  ``ops`` (a call, or a ``torch.Tensor`` annotation) in a module that
  imports ``torch`` are checked: the others handle host values (numpy
  arrays, Python ints), where these calls wait for nothing.  A loop's
  iterable is evaluated once, before it, and is not in the loop.
* **TX006** (JX006) — a function with a ``time.perf_counter()`` window
  that never calls ``torch.cuda.synchronize``, ``.synchronize()``,
  ``Event.elapsed_time`` or a device read (``.cpu()``, ``.item()``,
  ``.numpy()``, ``.tolist()``): CUDA launches are asynchronous, so the
  window times the enqueue, not the compute.  Suppress a host-only window
  with ``# lint: allow-timing`` anywhere in the function body.

JX002 (``np.*`` under jit) and JX003 (unhashable statics) have no meaning
in eager torch: there is no trace for numpy to concretize, and no static
argument keys a compiled program.

CLI::

    PYTHONPATH=src python -m repro_torch.analysis.lint [paths ...]

Default paths: ``src/repro_torch`` and ``chip_smoke.py``.  Prints every
finding and the number of suppressions, and exits 1 on any finding.
"""
from __future__ import annotations

import ast
import io
import re
import sys
import tokenize
from dataclasses import dataclass
from pathlib import Path

_SYNC_SCOPES = ("core", "serving", "kernels")
_CONCRETIZERS = ("bool", "int", "float")
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_READ_METHODS = ("cpu", "item", "numpy", "tolist", "synchronize",
                 "elapsed_time")
_SYNC_SUPPRESS = re.compile(r"#\s*lint:\s*allow-sync\b:?(.*)$")
_TIMING_SUPPRESS = "lint: allow-timing"


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _imports_torch(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import) and any(
                a.name.split(".")[0] == "torch" for a in node.names):
            return True
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == "torch":
            return True
    return False


def _in_sync_scope(path: str) -> bool:
    return any(p in _SYNC_SCOPES for p in Path(path).parts[:-1])


def _method(node: ast.AST) -> str | None:
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def _sync_reason(node: ast.AST) -> str | None:
    """Why ``node`` (an expression) syncs, or ``None``."""
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in _CONCRETIZERS and node.args \
                and not isinstance(node.args[0], ast.Constant):
            return f"`{f.id}()` on a non-literal"
        if _method(node) in _SYNC_METHODS:
            return f"`.{_method(node)}()`"
    return None


def _test_reason(test: ast.AST) -> str | None:
    for n in ast.walk(test):
        if _method(n) in ("any", "all"):
            return f"a test built from `.{_method(n)}()`"
    return None


class _LoopSyncs(ast.NodeVisitor):
    """Collect ``(line, end line, reason)`` of sync sites inside loops."""

    def __init__(self):
        self.depth = 0
        self.hits: list[tuple[int, int, str]] = []

    def _hit(self, node: ast.AST, reason: str) -> None:
        self.hits.append((node.lineno,
                          getattr(node, "end_lineno", node.lineno), reason))

    def _in_loop(self, nodes) -> None:
        self.depth += 1
        for n in nodes:
            self.visit(n)
        self.depth -= 1

    def visit_For(self, node):
        self.visit(node.iter)           # evaluated once, before the loop
        self._in_loop([node.target, *node.body, *node.orelse])

    visit_AsyncFor = visit_For

    def visit_While(self, node):
        reason = _test_reason(node.test)    # evaluated every iteration
        if reason:
            self._hit(node.test, reason)
        self._in_loop([node.test, *node.body, *node.orelse])

    def visit_comprehension_owner(self, node):
        # a comprehension loops over its generators; the first iterable is
        # evaluated once, outside
        gens = node.generators
        self.visit(gens[0].iter)
        inner = [gens[0].target, *gens[0].ifs]
        for g in gens[1:]:
            inner += [g.iter, g.target, *g.ifs]
        inner += [getattr(node, f) for f in ("elt", "key", "value")
                  if hasattr(node, f)]
        self._in_loop(inner)

    visit_ListComp = visit_SetComp = visit_DictComp = \
        visit_GeneratorExp = visit_comprehension_owner

    def visit_If(self, node):
        if self.depth:
            reason = _test_reason(node.test)
            if reason:
                self._hit(node.test, reason)
        self.generic_visit(node)

    def visit_Call(self, node):
        if self.depth:
            reason = _sync_reason(node)
            if reason:
                self._hit(node, reason)
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        pass                    # each def is visited on its own (a def in a
                                # loop runs later, not per iteration)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        saved, self.depth = self.depth, 0
        self.generic_visit(node)
        self.depth = saved

    def visit_body(self, fn) -> None:
        self.depth = 0
        for stmt in fn.body:
            self.visit(stmt)


def _comments(source: str) -> dict[int, str]:
    """``{line: comment}`` of the source's comments (strings that merely
    contain a ``#`` are not comments)."""
    out: dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, SyntaxError):
        pass
    return out


def _suppression(comments: dict[int, str], first: int, last: int):
    """``(found, reason)`` of an allow-sync comment on lines first..last."""
    for i in range(first, last + 1):
        m = _SYNC_SUPPRESS.search(comments.get(i, ""))
        if m:
            return True, m.group(1).strip()
    return False, ""


def _touches_torch(fn: ast.AST) -> bool:
    """Whether a function names ``torch`` or ``ops`` (the kernels): one that
    names neither holds no device tensor of its own."""
    return any(isinstance(n, ast.Name) and n.id in ("torch", "ops")
               for n in ast.walk(fn))


def _check_syncs(path: str, tree: ast.AST, comments: dict[int, str],
                 findings: list[Finding]) -> None:
    v = _LoopSyncs()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and _touches_torch(node):
            v.visit_body(node)
    seen = set()
    for first, last, reason in v.hits:
        if (first, reason) in seen:
            continue
        seen.add((first, reason))
        found, why = _suppression(comments, first, last)
        if found and why:
            continue
        if found:
            if (first, "no reason") in seen:
                continue
            seen.add((first, "no reason"))
            findings.append(Finding(
                path, first, "TX001",
                "`# lint: allow-sync` without a reason — say why this sync "
                "is meant (`# lint: allow-sync: <reason>`)"))
            continue
        findings.append(Finding(
            path, first, "TX001",
            f"{reason} inside a loop waits for the device every iteration "
            f"— keep the value on the device, or mark a deliberate sync "
            f"`# lint: allow-sync: <reason>`"))


def _check_timing(path: str, fn: ast.FunctionDef, comments: dict[int, str],
                  findings: list[Finding]) -> None:
    perf_lines: list[int] = []
    synced = False
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if name == "perf_counter":
                perf_lines.append(node.lineno)
            elif name in _READ_METHODS:
                synced = True
    if len(perf_lines) < 2 or synced:
        return
    end = getattr(fn, "end_lineno", fn.lineno) or fn.lineno
    if any(_TIMING_SUPPRESS in comments.get(i, "")
           for i in range(fn.lineno, end + 1)):
        return
    findings.append(Finding(
        path, perf_lines[0], "TX006",
        f"`{fn.name}` times a perf_counter window without "
        f"torch.cuda.synchronize or a device read — CUDA launches are "
        f"asynchronous, so this measures the enqueue, not the compute (add "
        f"the sync, or `# {_TIMING_SUPPRESS}` if the window is host-only)"))


def lint_source(source: str, path: str = "<string>") -> list[Finding]:
    tree = ast.parse(source, filename=path)
    comments = _comments(source)
    findings: list[Finding] = []
    if _in_sync_scope(path) and _imports_torch(tree):
        _check_syncs(path, tree, comments, findings)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _check_timing(path, node, comments, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def _files(paths) -> list[Path]:
    out: list[Path] = []
    for p in paths:
        p = Path(p)
        out += sorted(p.rglob("*.py")) if p.is_dir() else [p]
    return out


def lint_paths(paths) -> list[Finding]:
    findings: list[Finding] = []
    for f in _files(paths):
        findings.extend(lint_source(f.read_text(), str(f)))
    return findings


def count_suppressions(paths) -> int:
    """Suppression comments (``allow-sync`` and ``allow-timing``) in
    ``paths``: the CLI prints it, so a change that adds one shows it."""
    n = 0
    for f in _files(paths):
        for c in _comments(f.read_text()).values():
            n += bool(_SYNC_SUPPRESS.search(c)) + (_TIMING_SUPPRESS in c)
    return n


def default_paths() -> list[Path]:
    root = Path(__file__).resolve().parents[3]
    return [root / "src" / "repro_torch", root / "chip_smoke.py"]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    paths = argv or default_paths()
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    print(f"repro_torch.analysis.lint: {len(findings)} finding(s), "
          f"{count_suppressions(paths)} suppression(s) in {len(paths)} "
          f"path(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
