#!/usr/bin/env python
"""First-party lint gate (no third-party linters in this image).

Checks, in the spirit of the reference's `mix format --check-formatted` +
`credo --strict` + `clippy -D warnings` gates (ci.yml:54-94,127-142):

* every file compiles (syntax);
* no unused imports;
* no bare ``except:``;
* no mutable default arguments;
* no tabs in indentation, no trailing whitespace, files end with newline;
* no ``print(`` in library code (``vettore_tpu/``) outside explicitly
  allowed debug paths — errors are exceptions, output is the caller's job.

Exit 0 = clean; nonzero prints every finding.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TARGETS = ["vettore_tpu", "tests", "tools", "bench.py", "chip_smoke.py",
           "__graft_entry__.py"]
#: library files where print() is load-bearing (debug hooks, CLIs)
PRINT_OK = {"vettore_tpu/index/hnsw_build.py",
            "vettore_tpu/index/hnsw_knn_build.py"}


def _files():
    for t in TARGETS:
        p = ROOT / t
        if p.is_file():
            yield p
        else:
            yield from sorted(p.rglob("*.py"))


class _Lint(ast.NodeVisitor):
    def __init__(self, path, src):
        self.path = path
        self.rel = str(path.relative_to(ROOT))
        self.findings = []
        self.imported = {}  # name -> lineno
        self.used = set()
        self.src = src

    def flag(self, line, msg):
        self.findings.append(f"{self.rel}:{line}: {msg}")

    def visit_Import(self, node):
        for a in node.names:
            name = (a.asname or a.name).split(".")[0]
            self.imported.setdefault(name, node.lineno)

    def visit_ImportFrom(self, node):
        if node.module == "__future__":
            return
        for a in node.names:
            if a.name == "*":
                continue
            self.imported.setdefault(a.asname or a.name, node.lineno)

    def visit_Name(self, node):
        self.used.add(node.id)

    def visit_Attribute(self, node):
        self.generic_visit(node)

    def visit_ExceptHandler(self, node):
        if node.type is None:
            self.flag(node.lineno, "bare `except:` (catch a type, or BaseException explicitly)")
        self.generic_visit(node)

    def _check_defaults(self, node):
        for default in list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None
        ]:
            if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                self.flag(default.lineno, "mutable default argument")

    def visit_FunctionDef(self, node):
        self._check_defaults(node)
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node):
        self._check_defaults(node)
        self.generic_visit(node)

    def visit_Call(self, node):
        if (
            isinstance(node.func, ast.Name)
            and node.func.id == "print"
            and self.rel.startswith("vettore_tpu/")
            and self.rel not in PRINT_OK
        ):
            self.flag(node.lineno, "print() in library code")
        self.generic_visit(node)

    def finish(self):
        # __all__ / re-export names count as used
        for name, line in sorted(self.imported.items(), key=lambda kv: kv[1]):
            if name in self.used:
                continue
            if f'"{name}"' in self.src or f"'{name}'" in self.src:
                continue  # referenced in __all__ or docs
            self.flag(line, f"unused import `{name}`")


def lint_file(path: Path) -> list[str]:
    src = path.read_text()
    rel = str(path.relative_to(ROOT))
    findings = []
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as exc:
        return [f"{rel}:{exc.lineno}: syntax error: {exc.msg}"]
    v = _Lint(path, src)
    v.visit(tree)
    v.finish()
    findings.extend(v.findings)
    lines = src.splitlines()
    for i, line in enumerate(lines, 1):
        stripped = line.rstrip("\n")
        if stripped != stripped.rstrip():
            findings.append(f"{rel}:{i}: trailing whitespace")
        if line[: len(line) - len(line.lstrip())].count("\t"):
            findings.append(f"{rel}:{i}: tab indentation")
    if src and not src.endswith("\n"):
        findings.append(f"{rel}:{len(lines)}: missing trailing newline")
    return findings


def main() -> int:
    all_findings = []
    count = 0
    for path in _files():
        count += 1
        all_findings.extend(lint_file(path))
    if all_findings:
        print("\n".join(all_findings))
        print(f"\nlint: {len(all_findings)} finding(s) in {count} files")
        return 1
    print(f"lint: clean ({count} files)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
