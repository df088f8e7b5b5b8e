"""The benchmark's promise that it measures the port alone: no process of
a run holds JAX or the JAX package, compared by whole top-level module
names (the port's ``bdlz_tpu_torch`` shares a prefix with ``bdlz_tpu``)."""
from __future__ import annotations

import ast
import pathlib
import sys
from typing import Iterable, List, Set

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "bdlz_tpu"})
PROGRAM = "bdlz_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & FORBIDDEN)


def imports_of(path: pathlib.Path) -> Set[str]:
    """The top-level names a source file imports (absolute imports)."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top_level(node.module))
    return out
