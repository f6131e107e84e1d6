#!/usr/bin/env python
"""Self-contained lint gate (reference analog: Makefile:54-65 runs
clang-format/clang-tidy/cpplint/black; none of those are in this image, so
this enforces the subset that matters mechanically):

* every Python file byte-compiles;
* no tabs, no trailing whitespace, newline at EOF;
* line length <= 88 (black's default) for Python, <= 100 for C++;
* no `print(` in libsbn_tpu/ outside the allowlisted user-facing modules;
* AST-level unused-import check per file.

Exit 0 = clean. Run via `make lint`.
"""

from __future__ import annotations

import ast
import pathlib
import os
import py_compile
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
PY_DIRS = ["libsbn_tpu", "tests", "tools"]
PY_FILES_TOP = ["bench.py", "__graft_entry__.py"]
CPP_DIRS = ["native"]
MAX_PY = 88       # library code (black's default)
MAX_PY_TEST = 100  # tests/tools carry wide golden-number tables
MAX_CPP = 100
# Modules whose job is user-facing console output (PrintStatus analogs).
PRINT_OK = {
    "vi/cli.py", "vi/benchmark.py", "vi/burrito.py", "vi/optimizers.py",
    "instance/generic.py", "gp/instance.py", "gp/engine.py",
    "utils/profiling.py", "sbn/probability.py", "io/native.py",
}


def iter_py():
    for d in PY_DIRS:
        yield from sorted((ROOT / d).rglob("*.py"))
    for f in PY_FILES_TOP:
        yield ROOT / f


def iter_cpp():
    for d in CPP_DIRS:
        for pat in ("*.cpp", "*.h", "*.hpp"):
            yield from sorted((ROOT / d).rglob(pat))


def check_text(path, text, max_len, errors):
    rel = path.relative_to(ROOT)
    if text and not text.endswith("\n"):
        errors.append(f"{rel}: missing newline at EOF")
    for i, line in enumerate(text.splitlines(), 1):
        if "\t" in line:
            errors.append(f"{rel}:{i}: tab character")
        if line != line.rstrip():
            errors.append(f"{rel}:{i}: trailing whitespace")
        if len(line) > max_len and "http" not in line:
            errors.append(f"{rel}:{i}: line length {len(line)} > {max_len}")


def unused_imports(path, tree, errors):
    rel = path.relative_to(ROOT)
    imported = {}  # name -> lineno
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                imported[(a.asname or a.name).split(".")[0]] = node.lineno
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name != "*":
                    imported[a.asname or a.name] = node.lineno
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            pass
    # __all__ re-exports and annotations count as use.
    src_names = used | {
        n for node in ast.walk(tree) if isinstance(node, ast.Constant)
        and isinstance(node.value, str) for n in [node.value]
    }
    for name, lineno in imported.items():
        if name not in src_names and name != "annotations":
            errors.append(f"{rel}:{lineno}: unused import '{name}'")


def main():
    errors = []
    for path in iter_py():
        text = path.read_text()
        rel = str(path.relative_to(ROOT))
        is_lib = rel.startswith("libsbn_tpu/") or rel in PY_FILES_TOP
        check_text(path, text, MAX_PY if is_lib else MAX_PY_TEST, errors)
        try:
            py_compile.compile(
                str(path), doraise=True,
                cfile=os.path.join(tempfile.gettempdir(), "lint_cache.pyc"),
            )
        except py_compile.PyCompileError as exc:
            errors.append(f"{rel}: does not compile: {exc.msg}")
            continue
        tree = ast.parse(text)
        unused_imports(path, tree, errors)
        if rel.startswith("libsbn_tpu/"):
            sub = rel[len("libsbn_tpu/"):]
            if sub not in PRINT_OK:
                for i, line in enumerate(text.splitlines(), 1):
                    stripped = line.strip()
                    if stripped.startswith("print(") and "noqa" not in line:
                        errors.append(f"{rel}:{i}: print() in library code")
    for path in iter_cpp():
        check_text(path, path.read_text(), MAX_CPP, errors)
    if errors:
        print("\n".join(errors))
        print(f"\nlint: {len(errors)} issue(s)")
        return 1
    print("lint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
