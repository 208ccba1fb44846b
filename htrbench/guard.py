"""The check that nothing the benchmark runs loads JAX or the JAX package.

Modules are compared by their top-level name, the part before the first
dot, taken whole: ``htr_vt_torch`` (the port) begins with the letters of
``htr_vt_tpu`` and is not it.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "htr_vt_tpu")
PORT = "htr_vt_torch"
REFERENCE_DIR = Path(__file__).resolve().parent / "reference"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules: Iterable[str] | None = None) -> List[str]:
    """The loaded modules (``sys.modules`` by default) whose top-level name
    is one of ``FORBIDDEN``."""
    names = list(sys.modules) if modules is None else list(modules)
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def reference_imports(directory: Path = REFERENCE_DIR) -> List[str]:
    """Every module the reference's sources import by name (absolute
    imports), read from their syntax trees."""
    out = []
    for path in sorted(directory.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                out += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                out.append(node.module)
    return out


def reference_faults(directory: Path = REFERENCE_DIR) -> List[str]:
    """The reference's imports of the port, of JAX or of the JAX package."""
    return sorted({m for m in reference_imports(directory)
                   if top_level(m) in FORBIDDEN + (PORT,)})


def check(where: str) -> None:
    """Exit 3 naming what was found, if a forbidden module is loaded or the
    reference imports the port."""
    found = forbidden_loaded()
    bad_ref = reference_faults()
    if found or bad_ref:
        if found:
            print(f"htrbench: {where}: forbidden modules loaded: {', '.join(found)}",
                  file=sys.stderr)
        if bad_ref:
            print(f"htrbench: {where}: the reference imports {', '.join(bad_ref)}",
                  file=sys.stderr)
        raise SystemExit(3)
