"""The port's AST lint: the source-level half of the round contract.

Port of ``src/repro/analysis/astlint.py``, its four rules in torch idiom:

RPR001  host-sync-in-core     ``.item()``, ``.tolist()``, ``.cpu()``,
                              ``.numpy()``, ``torch.cuda.synchronize`` or
                              ``np.asarray`` inside ``repro_torch/core/``: a
                              host read in a round serializes the host with
                              the card.  ``core/topology.py`` is exempt (its
                              float64 spectral math is host-side by design).
RPR002  compressor-dispatch   ``isinstance(…, *Compressor)`` outside
                              ``core/wire.py``: codec dispatch has one home
                              (``make_codec``).
RPR003  lane-literal          a bare ``1024`` outside ``repro_torch/kernels/``:
                              the lane width is ``LANE``.  A 1024 that is not
                              the lane carries the pragma.
RPR004  config-at-import      a module-level ``torch.backends.*`` assignment,
                              ``torch.set_default_dtype`` or
                              ``torch.use_deterministic_algorithms`` outside
                              ``repro_torch/__init__.py``: import-time settings
                              make behaviour depend on import order.

``# lint: allow`` on the offending line suppresses any rule (each pragma
is a documented exception).

    python -m repro_torch.analysis.astlint              # src/repro_torch
    python -m repro_torch.analysis.astlint src tests    # explicit roots

Exit 0: clean, 1: violations, 2: a root that does not exist.  The module
imports nothing but the standard library.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import os
import sys
from typing import List

__all__ = ["LintError", "lint_source", "lint_paths", "iter_py_files",
           "main"]

PRAGMA = "lint: allow"
LANE_WIDTH = 1024      # the rule's own reference value  # lint: allow
# the calls that read a tensor on the host, by their trailing name
HOST_READS = ("item", "tolist", "cpu", "numpy")
# <checkout>/src/repro_torch/analysis/astlint.py
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


@dataclasses.dataclass(frozen=True)
class LintError:
    path: str
    line: int
    rule: str
    msg: str

    def __str__(self):
        return f"{self.path}:{self.line}: {self.rule} {self.msg}"


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _dotted(node) -> str:
    """Best-effort dotted name of an expression
    (``torch.cuda.synchronize``)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


class _Linter(ast.NodeVisitor):
    def __init__(self, rel_path: str, src_lines: List[str]):
        self.rel = _norm(rel_path)
        self.lines = src_lines
        self.errors: List[LintError] = []
        self._func_depth = 0
        self.in_core = ("repro_torch/core/" in self.rel
                        and not self.rel.endswith("core/topology.py"))

    def _err(self, node, rule: str, msg: str):
        ln = getattr(node, "lineno", 0)
        if 1 <= ln <= len(self.lines) and PRAGMA in self.lines[ln - 1]:
            return
        self.errors.append(LintError(self.rel, ln, rule, msg))

    def visit_FunctionDef(self, node):
        self._func_depth += 1
        self.generic_visit(node)
        self._func_depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef

    # ---- RPR001 / RPR002 / RPR004 (calls)
    def visit_Call(self, node: ast.Call):
        dotted = _dotted(node.func)
        if self.in_core:
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in HOST_READS and not node.args
                    and dotted not in ("np.cpu", "torch.cpu")):
                self._err(node, "RPR001",
                          f".{node.func.attr}() in core/ — a host read in "
                          "the round's code")
            if dotted in ("torch.cuda.synchronize", "cuda.synchronize"):
                self._err(node, "RPR001",
                          "torch.cuda.synchronize in core/ — a host sync in "
                          "the round's code")
            if dotted in ("np.asarray", "numpy.asarray"):
                self._err(node, "RPR001",
                          "np.asarray in core/ — a device→host transfer "
                          "(topology.py is the one host-side module)")
        if (dotted == "isinstance" and len(node.args) == 2
                and not self.rel.endswith("core/wire.py")):
            cls = node.args[1]
            for c in (cls.elts if isinstance(cls, ast.Tuple) else [cls]):
                name = _dotted(c)
                if name.split(".")[-1].endswith("Compressor"):
                    self._err(node, "RPR002",
                              f"isinstance(…, {name}) — compressor "
                              "dispatch belongs to core/wire.py "
                              "(make_codec)")
                    break
        if (dotted in ("torch.set_default_dtype",
                       "torch.use_deterministic_algorithms")
                and self._func_depth == 0 and not self._init()):
            self._err(node, "RPR004",
                      f"module-level {dotted} — import-time setting outside "
                      "repro_torch/__init__.py")
        self.generic_visit(node)

    # ---- RPR004 (assignments)
    def visit_Assign(self, node: ast.Assign):
        self._config_target(node, node.targets)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._config_target(node, [node.target])
        self.generic_visit(node)

    def _config_target(self, node, targets):
        if self._func_depth or self._init():
            return
        for t in targets:
            if _dotted(t).startswith("torch.backends."):
                self._err(node, "RPR004",
                          f"module-level {_dotted(t)} = … — import-time "
                          "setting outside repro_torch/__init__.py")

    def _init(self) -> bool:
        return self.rel.endswith("repro_torch/__init__.py")

    # ---- RPR003
    def visit_Constant(self, node: ast.Constant):
        if (type(node.value) is int and node.value == LANE_WIDTH
                and "repro_torch/kernels/" not in self.rel):
            self._err(node, "RPR003",
                      "hardcoded 1024 — use the LANE constant "
                      "(repro_torch.kernels.LANE) or mark a genuine "
                      "non-lane constant with `# lint: allow`")
        self.generic_visit(node)


def lint_source(src: str, rel_path: str) -> List[LintError]:
    """Lint one file's source text; ``rel_path`` is repo-relative."""
    try:
        tree = ast.parse(src, filename=rel_path)
    except SyntaxError as e:
        return [LintError(_norm(rel_path), e.lineno or 0, "RPR000",
                          f"syntax error: {e.msg}")]
    linter = _Linter(rel_path, src.splitlines())
    linter.visit(tree)
    return sorted(linter.errors, key=lambda e: (e.path, e.line))


def iter_py_files(roots):
    for root in roots:
        if os.path.isfile(root):
            if root.endswith(".py"):
                yield root
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git"))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def lint_paths(roots, base: str = ".") -> List[LintError]:
    """Lint every ``.py`` under the given roots (files or directories)."""
    out: List[LintError] = []
    for path in iter_py_files(roots):
        with open(path, encoding="utf-8") as f:
            out.extend(lint_source(f.read(), os.path.relpath(path, base)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's AST lint")
    ap.add_argument("roots", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint (relative ones "
                         "from the checkout's root)")
    args = ap.parse_args(argv)
    roots = [r if os.path.isabs(r) else os.path.join(REPO, r)
             for r in args.roots]
    missing = [r for r in roots if not os.path.exists(r)]
    if missing:
        print(f"astlint: no such path(s): {missing}", file=sys.stderr)
        return 2
    errors = lint_paths(roots, base=REPO)
    for e in errors:
        print(e)
    if errors:
        print(f"\nastlint: {len(errors)} violation(s)", file=sys.stderr)
        return 1
    print("astlint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
