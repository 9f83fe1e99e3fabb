"""Transitive-import analysis over the port's own sources.

The torch-freedom of ``obs/``, ``fleet/``, ``continual/`` and ``policy/``
is about what importing the package ultimately PULLS IN, not about what
strings appear in its files: a refactor that makes ``obs/registry.py``
import a helper from ``engine/`` would pass every text search while
quietly making the package import torch at module load.  This module
resolves imports statically (``ast.Import``/``ImportFrom``, relative
levels included), follows edges through ``dryad_tpu_torch``-internal
modules, and reports the full chain that reaches a banned root.

Only MODULE-LEVEL imports count: a function-local import inside an
internal module is a lazy edge that importing the package does not
execute.  (The packages themselves are also barred from lazy torch
imports by the direct-ban rules in rules.py, so the split cannot be
gamed from inside them.)

The counterpart of ``dryad_tpu/analysis/importgraph.py``.
"""

from __future__ import annotations

import ast
from typing import Iterable


def module_name(relpath: str) -> str:
    """'dryad_tpu_torch/obs/spans.py' -> 'dryad_tpu_torch.obs.spans'."""
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    if mod.endswith("/__init__"):
        mod = mod[: -len("/__init__")]
    return mod.replace("/", ".")


def module_path_candidates(mod: str) -> list[str]:
    base = mod.replace(".", "/")
    return [base + ".py", base + "/__init__.py"]


def module_level_imports(tree: ast.Module, mod: str,
                         is_package: bool) -> set[str]:
    """Absolute module names imported at module level (relative resolved
    against ``mod``).  Conditional module-level imports (try/except, if)
    count — they execute at import time on some path."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.Import):
            if _inside_function(tree, node):
                continue
            for alias in node.names:
                out.add(alias.name)
        elif isinstance(node, ast.ImportFrom):
            if _inside_function(tree, node):
                continue
            if node.level == 0:
                base = node.module or ""
            else:
                parts = mod.split(".")
                # a package's own __init__ resolves level-1 against itself
                anchor = parts if is_package else parts[:-1]
                up = node.level - 1
                anchor = anchor[: len(anchor) - up] if up else anchor
                base = ".".join(anchor
                                + ([node.module] if node.module else []))
            if base:
                out.add(base)
                # ``from pkg import sub`` may bind a submodule: record the
                # candidate edges too, resolved later only if they exist
                for alias in node.names:
                    out.add(f"{base}.{alias.name}")
    return out


def _inside_function(tree: ast.Module, target: ast.AST) -> bool:
    """True when ``target`` sits under a function def (lazy import)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(node):
                if sub is target:
                    return True
    return False


def find_banned_chains(entry_files: Iterable[str], tree,
                       banned_roots: tuple,
                       internal_prefix: str = "dryad_tpu_torch"
                       ) -> list[tuple]:
    """BFS the import graph from ``entry_files`` (repo-relative paths)
    through the tree's own sources; return ``(chain, banned)`` tuples where
    ``chain`` is the module path from an entry to the import site that
    reaches a ``banned_roots`` module.  Edges into modules outside
    ``internal_prefix`` (stdlib, numpy, ...) terminate unless banned."""
    results: list[tuple] = []
    seen: set[str] = set()
    queue: list[tuple[str, tuple]] = []
    for rel in entry_files:
        queue.append((rel, (module_name(rel),)))

    while queue:
        rel, chain = queue.pop(0)
        if rel in seen:
            continue
        seen.add(rel)
        try:
            src = tree.read(rel)
            mod_ast = ast.parse(src, filename=rel)
        except (OSError, SyntaxError):
            continue
        mod = module_name(rel)
        is_pkg = rel.endswith("__init__.py")
        for imp in sorted(module_level_imports(mod_ast, mod, is_pkg)):
            root = imp.split(".")[0]
            if root in banned_roots:
                results.append((chain + (imp,), root))
                continue
            if root != internal_prefix:
                continue
            for cand in module_path_candidates(imp):
                if tree.exists(cand):
                    queue.append((cand, chain + (module_name(cand),)))
                    break
    return results
