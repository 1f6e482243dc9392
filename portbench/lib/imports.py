"""The benchmark's import checks: the JAX package, JAX and Flax never load
in a benchmark process, and the plain reference imports nothing of the
program under test.  Module names are compared by their top-level name
(the part before the first dot), whole: the program's package name
begins with the JAX package's."""

from __future__ import annotations

import ast
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "pointcloud_render_tpu")
PROGRAM = "pointcloud_render_tpu_torch"
REFERENCE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "reference")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list:
    """Names in ``sys.modules`` (or ``modules``) whose top-level name is
    one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def imported_names(path: str) -> list:
    """Every module a Python file imports (absolute names)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return out


def reference_imports_program(ref_dir: str = REFERENCE_DIR) -> list:
    """(file, module) of each import in the reference whose top-level name
    is the program's or a forbidden one."""
    bad = []
    for fname in sorted(os.listdir(ref_dir)):
        if fname.endswith(".py"):
            for mod in imported_names(os.path.join(ref_dir, fname)):
                if top_level(mod) in FORBIDDEN + (PROGRAM,):
                    bad.append((fname, mod))
    return bad
