"""What a run may not load, and what the benchmark's files may not import.

Names are compared whole, after splitting at the first dot: the port,
``lhvi_tpu_torch``, begins with the JAX package's name, ``lhvi_tpu``, so a
prefix test would be wrong.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "lhvi_tpu"})
PROGRAM = "lhvi_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(module_names: Iterable[str]) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    return sorted(n for n in module_names if top_level(n) in FORBIDDEN)


def imported_top_levels(source: str) -> set:
    """Top-level names a Python source imports (absolute imports)."""
    out = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(top_level(node.module or ""))
    return out


def source_offences(root: Path) -> List[str]:
    """Files under ``root`` that import JAX or the JAX package, and files
    under ``root/reference`` that import the program besides, as
    ``path: name``."""
    root = Path(root)
    bad = []
    for p in sorted(root.rglob("*.py")):
        rel = p.relative_to(root)
        banned = FORBIDDEN | ({PROGRAM} if rel.parts[0] == "reference"
                              else set())
        names = imported_top_levels(p.read_text())
        bad += [f"{rel.as_posix()}: {n}" for n in sorted(names & banned)]
    return bad
