"""Torch hot-path linter: an AST pass over the port that catches the
per-call host syncs and host branches that cost the port its device time.

The port's hot paths run eager PyTorch on the card: the NoC twin's cycle
loop (``kernels/noc_step.run_plain`` around ``cycle_step``), the kernel
wrappers, and the model zoo's forward.  A host sync there (a tensor read
back to Python) stalls the host until the device drains, once per cycle
or per layer; a Python ``if`` on a tensor value is the same sync in
disguise.  Both pass the test suite (results stay right) and show up only
as device idle time, so a static pass is the cheap place to catch them.

Rules (the torch forms of ``repro.analysis.lint_jax``'s)
-----------------------------------------------------
* **TORCH001 host-sync** — ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``float(x)``/``int(x)``/``bool(x)`` of a tensor
  expression, or ``torch.cuda.synchronize()`` inside a hot path.  Shape
  arithmetic is exempt (``int(x.shape[0])`` reads no device memory).
* **TORCH002 tensor-branch** — ``if``/``while`` on an expression that
  mentions a (non-static) parameter of a hot function: Python control
  flow on a tensor reads it back to the host.  ``x is None`` tests,
  branches on int/bool/str-annotated parameters (configuration by
  convention), and shape/len/isinstance/device tests are exempt; the
  operands of ``and``/``or`` are judged one by one.
* **TORCH004 mutable-default** — a dataclass field whose default is a
  mutable literal (``= []`` / ``= {}``): shared across instances, and it
  breaks the frozen specs' hashability contract.

The reference's JAX003 (static arguments of ``jax.jit`` that force a
recompile per value) has no counterpart: nothing in the port is jitted or
``torch.compile``d, so no argument is a compile key.

Hot paths are:

* functions named ``cycle_step`` / ``run_fused`` / ``*_kernel`` (the
  kernel naming convention), and everything lexically nested inside one;
* the per-cycle loop of ``kernels/noc_step.py`` ``run_plain``: the body
  (and a ``while`` loop's test) of every loop in it, while the set-up
  before the loop and the readouts after it stay cold;
* ``models/model.py`` ``forward`` and the block functions (``*_block``)
  of ``models/layers.py``.

Audited exceptions live in ``analysis/lint_allowlist.txt`` as
``path-suffix:RULE:qualname`` lines (``*`` wildcards the qualname);
every entry carries a comment saying *why* the finding is safe.

CLI::

    PYTHONPATH=src python -m repro_torch.analysis.lint_torch \\
        src/repro_torch chip_smoke.py
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
from typing import Optional

RULES = {
    "TORCH001": "host sync in hot path",
    "TORCH002": "python branch on tensor value in hot path",
    "TORCH004": "mutable dataclass field default",
}

# Names that make a function hot wherever it is defined.
_HOT_NAMES = ("cycle_step", "run_fused")
_HOT_SUFFIX = "_kernel"
# Functions hot in one module only: (path suffix, name patterns).
_HOT_FUNCS = (("models/model.py", ("forward",)),
              ("models/layers.py", ("*_block",)))
# Functions whose loops are hot: the per-cycle loop of the plain twin.
_HOT_LOOPS = (("kernels/noc_step.py", ("run_plain",)),)

# Methods that copy a tensor to the host (or wait for the device).
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_SYNC_CALLS = ("torch.cuda.synchronize", "cuda.synchronize")

# Annotations that mark a parameter as configuration, not a tensor:
# branching on these reads nothing from the device.
_STATIC_ANNOTATIONS = {"int", "bool", "str", "Optional[int]", "Optional[str]",
                       "Optional[bool]", "int | None", "str | None",
                       "bool | None"}

# Attribute mentions that mean "shape arithmetic" or placement: tensor
# metadata, which reads no device memory.
_SHAPE_WORDS = ("shape", "ndim", "size", "dtype", "device")

DEFAULT_ALLOWLIST = os.path.join(os.path.dirname(__file__),
                                 "lint_allowlist.txt")


@dataclasses.dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    rule: str
    qualname: str
    message: str

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} "
                f"[{RULES[self.rule]}] in `{self.qualname}`: {self.message}")


# ---------------------------------------------------------------------------
# Small AST helpers.
# ---------------------------------------------------------------------------
def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for Attribute/Name chains, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _mentions_shape(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _SHAPE_WORDS:
            return True
        if isinstance(sub, ast.Call):
            f = _dotted(sub.func)
            if f in ("len", "isinstance", "hasattr", "getattr", "type"):
                return True
    return False


def _is_none_test(node: ast.AST) -> bool:
    """``x is None`` / ``x is not None`` (or a pure bool-op of such):
    structure of the call, not a tensor value."""
    if isinstance(node, ast.BoolOp):
        return all(_is_none_test(v) for v in node.values)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        return _is_none_test(node.operand)
    return (isinstance(node, ast.Compare)
            and len(node.ops) == 1
            and isinstance(node.ops[0], (ast.Is, ast.IsNot))
            and isinstance(node.comparators[0], ast.Constant)
            and node.comparators[0].value is None)


def _annotation_str(ann: Optional[ast.AST]) -> str:
    return "" if ann is None else ast.unparse(ann)


def _mutable_default(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return _dotted(node.func) in ("list", "dict", "set", "bytearray")
    return False


def _tensor_params(fn) -> set[str]:
    """Parameter names of ``fn`` that may hold tensors: everything except
    self/cls and parameters whose annotation marks them configuration."""
    a = fn.args
    return {arg.arg for arg in (list(a.posonlyargs) + list(a.args)
                                + list(a.kwonlyargs))
            if arg.arg not in ("self", "cls")
            and _annotation_str(arg.annotation) not in _STATIC_ANNOTATIONS}


def _matches(path: str, table, name: str) -> bool:
    norm = path.replace(os.sep, "/")
    return any(norm.endswith(suffix)
               and any(fnmatch.fnmatchcase(name, pat) for pat in pats)
               for suffix, pats in table)


# ---------------------------------------------------------------------------
# The linter.
# ---------------------------------------------------------------------------
class _Linter(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: list[LintFinding] = []
        # (name, hot, loops_hot) per enclosing function
        self.fn_stack: list[tuple[str, bool, bool]] = []
        self.tensors: list[set[str]] = []   # tensor params per hot frame
        self.hot_loops = 0                  # depth inside a hot loop

    # -- hot-path bookkeeping ----------------------------------------------
    def _in_hot(self) -> bool:
        return self.hot_loops > 0 or any(hot for _, hot, _ in self.fn_stack)

    def _qualname(self) -> str:
        return ".".join(n for n, _, _ in self.fn_stack) or "<module>"

    def _is_hot_def(self, fn) -> bool:
        return (self._in_hot() or fn.name in _HOT_NAMES
                or fn.name.endswith(_HOT_SUFFIX)
                or _matches(self.path, _HOT_FUNCS, fn.name))

    def _emit(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(LintFinding(
            path=self.path, line=getattr(node, "lineno", 0), rule=rule,
            qualname=self._qualname(), message=msg))

    # -- visitors -----------------------------------------------------------
    def visit_FunctionDef(self, fn) -> None:
        hot = self._is_hot_def(fn)
        loops = not hot and _matches(self.path, _HOT_LOOPS, fn.name)
        self.fn_stack.append((fn.name, hot, loops))
        self.tensors.append(_tensor_params(fn) if hot or loops else set())
        self.generic_visit(fn)
        self.fn_stack.pop()
        self.tensors.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _loops_hot(self) -> bool:
        return bool(self.fn_stack) and self.fn_stack[-1][2]

    def visit_For(self, node: ast.For) -> None:
        if not self._loops_hot():
            self.generic_visit(node)
            return
        self.visit(node.target)
        self.visit(node.iter)            # evaluated once: cold
        self.hot_loops += 1
        for stmt in node.body + node.orelse:
            self.visit(stmt)
        self.hot_loops -= 1

    visit_AsyncFor = visit_For

    def visit_While(self, node: ast.While) -> None:
        hot_loop = self._loops_hot()
        self.hot_loops += hot_loop       # the test runs every iteration
        self._check_branch(node, node.test, "while")
        self.generic_visit(node)
        self.hot_loops -= hot_loop

    def _tensor_in(self, node: ast.AST) -> Optional[str]:
        """A tensor-parameter name mentioned in ``node`` (from any
        enclosing hot frame), or None."""
        names = set().union(*self.tensors) if self.tensors else set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and sub.id in names:
                return sub.id
        return None

    def _check_branch(self, node, test: ast.AST, kind: str) -> None:
        if not self._in_hot():
            return
        if isinstance(test, ast.BoolOp):   # each operand on its own
            for value in test.values:
                self._check_branch(node, value, kind)
            return
        if _is_none_test(test) or _mentions_shape(test):
            return
        name = self._tensor_in(test)
        if name is not None:
            self._emit(node, "TORCH002",
                       f"`{kind}` on `{name}` reads a tensor back to the "
                       f"host; use torch.where, or annotate the parameter "
                       f"as configuration")

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node, node.test, "if")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if self._in_hot():
            f = node.func
            fname = _dotted(f)
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
                self._emit(node, "TORCH001",
                           f"`.{f.attr}()` copies a tensor to the host "
                           f"(a device sync per call)")
            elif fname in _SYNC_CALLS:
                self._emit(node, "TORCH001",
                           f"`{fname}()` waits for the device")
            elif fname in ("float", "int", "bool") and len(node.args) == 1:
                arg = node.args[0]
                if (isinstance(arg, (ast.Name, ast.Attribute, ast.Subscript,
                                     ast.Call))
                        and not _mentions_shape(arg)):
                    self._emit(node, "TORCH001",
                               f"`{fname}()` of a tensor reads it back to "
                               f"the host; shape arithmetic is exempt")
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        is_dc = any("dataclass" in _dotted(d if not isinstance(d, ast.Call)
                                           else d.func)
                    for d in node.decorator_list)
        if is_dc:
            for stmt in node.body:
                if (isinstance(stmt, ast.AnnAssign) and stmt.value is not None
                        and _mutable_default(stmt.value)):
                    self.findings.append(LintFinding(
                        path=self.path, line=stmt.lineno, rule="TORCH004",
                        qualname=node.name,
                        message="mutable default shared across instances; "
                                "use dataclasses.field(default_factory=...)"))
        self.generic_visit(node)


def lint_source(source: str, path: str = "<string>") -> list[LintFinding]:
    """Lint one module's source text; returns unfiltered findings."""
    tree = ast.parse(source, filename=path)
    linter = _Linter(path)
    linter.visit(tree)
    return sorted(linter.findings, key=lambda f: (f.path, f.line, f.rule))


# ---------------------------------------------------------------------------
# Allowlist + file walking.
# ---------------------------------------------------------------------------
def load_allowlist(path: Optional[str]) -> list[tuple[str, str, str]]:
    """``(path_suffix, rule, qualname)`` entries; '*' wildcards the
    qualname.  Missing file -> empty list."""
    if path is None or not os.path.exists(path):
        return []
    entries = []
    with open(path) as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split(":")
            if len(parts) != 3:
                raise ValueError(
                    f"{path}: bad allowlist line {raw.strip()!r} "
                    f"(want path-suffix:RULE:qualname)")
            entries.append((parts[0], parts[1], parts[2]))
    return entries


def _allowed(f: LintFinding, allow: list[tuple[str, str, str]]) -> bool:
    norm = f.path.replace(os.sep, "/")
    return any(norm.endswith(suffix) and f.rule == rule
               and (qual == "*" or qual == f.qualname)
               for suffix, rule, qual in allow)


def iter_py_files(paths: list[str]):
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)


def lint_paths(paths: list[str],
               allowlist: Optional[str] = DEFAULT_ALLOWLIST
               ) -> tuple[list[LintFinding], list[LintFinding]]:
    """Lint files/trees; returns ``(reported, allowlisted)``."""
    allow = load_allowlist(allowlist)
    reported: list[LintFinding] = []
    silenced: list[LintFinding] = []
    for path in iter_py_files(paths):
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        for f in lint_source(src, path):
            (silenced if _allowed(f, allow) else reported).append(f)
    return reported, silenced


def main(argv: Optional[list] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint_torch",
        description="Torch hot-path linter (host syncs, branches on "
                    "tensors, mutable dataclass defaults).")
    p.add_argument("paths", nargs="*", default=None,
                   help="files or directories (default: src/repro_torch "
                        "if present, else the repro_torch package)")
    p.add_argument("--allowlist", default=DEFAULT_ALLOWLIST,
                   help="audited-exception file (default: the checked-in "
                        "analysis/lint_allowlist.txt)")
    p.add_argument("--no-allowlist", action="store_true",
                   help="report allowlisted findings too")
    args = p.parse_args(argv)

    paths = args.paths
    if not paths:
        paths = (["src/repro_torch"] if os.path.isdir("src/repro_torch")
                 else [os.path.dirname(os.path.dirname(
                     os.path.abspath(__file__)))])
    allowlist = None if args.no_allowlist else args.allowlist
    reported, silenced = lint_paths(paths, allowlist)
    for f in reported:
        print(f.render())
    if silenced:
        print(f"# {len(silenced)} finding(s) allowlisted "
              f"({args.allowlist})")
    n_files = sum(1 for _ in iter_py_files(paths))
    print(f"# lint_torch: {len(reported)} finding(s) in {n_files} files")
    return 1 if reported else 0


if __name__ == "__main__":
    raise SystemExit(main())
