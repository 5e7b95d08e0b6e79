"""The rule that no run loads JAX or the JAX package: top-level module
names compared whole (the program's own name begins with the JAX
package's)."""

from __future__ import annotations

import ast
import os
import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "snn_for_object_detection_tpu")
PROGRAM = "snn_for_object_detection_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (``sys.modules``)."""
    names = list(sys.modules) if names is None else names
    return sorted({top_level(n) for n in names} & set(FORBIDDEN))


def imported_names(path: str) -> List[str]:
    """Every module a Python file imports, as written."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            out.append(node.module)
    return out


def files_importing(folder: str, names: Iterable[str]) -> List[str]:
    """The ``.py`` files under ``folder`` that import a top-level name
    in ``names``."""
    names = set(names)
    bad = []
    for base, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                if {top_level(n) for n in imported_names(path)} & names:
                    bad.append(path)
    return sorted(bad)
