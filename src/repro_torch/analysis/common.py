"""Shared plumbing for the `repro_torch.analysis` static passes, the
port's copy of `repro.analysis.common`.

Everything here is pure stdlib `ast` work: findings, module discovery,
parsing, and the small name helpers the rule passes share. The passes
never *import* the code under analysis — they parse it — so the suite
runs identically on the port's tree, on the reference's beside it and on
the deliberately-broken fixture corpus in `tests/fixtures/analysis/`.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Iterable, List, Optional

#: `src/` root of the repo this package is installed in.
SRC_ROOT = Path(__file__).resolve().parents[2]
#: the package tree scanned by default (`python -m repro_torch.analysis`).
PKG_ROOT = SRC_ROOT / "repro_torch"


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def package_dirs(path: Path) -> Optional[tuple]:
    """The directories of `path` inside its package under `src/` (the
    port's, or the reference's beside it, so that the rules placed by
    directory read both trees alike); None for a file outside `src/`."""
    try:
        return path.relative_to(SRC_ROOT).parts[1:-1]
    except ValueError:
        return None


def default_files() -> List[Path]:
    """Every module of the installed `repro_torch` tree except this
    package (the analyzers do not analyze themselves)."""
    return [p for p in sorted(PKG_ROOT.rglob("*.py"))
            if "analysis" not in p.relative_to(PKG_ROOT).parts]


class ModuleSet:
    """Parsed modules keyed by path, with display-relative names."""

    def __init__(self, files: Iterable[Path]):
        self.trees: Dict[Path, ast.Module] = {}
        for path in files:
            path = Path(path).resolve()
            self.trees[path] = ast.parse(path.read_text(),
                                         filename=str(path))

    def display(self, path: Path) -> str:
        try:
            return str(path.relative_to(SRC_ROOT.parent))
        except ValueError:
            return str(path)

    def finding(self, path: Path, node: ast.AST, rule: str,
                message: str) -> Finding:
        return Finding(self.display(path), getattr(node, "lineno", 0),
                       rule, message)


def trailing_name(node: ast.AST) -> Optional[str]:
    """The rightmost identifier of a name-ish expression:
    `hw` -> hw, `self.hw` -> hw, `eng.hw[v]` -> hw, calls -> None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        return trailing_name(node.value)
    return None


def root_name(node: ast.AST) -> Optional[str]:
    """The leftmost identifier of an attribute/subscript chain:
    `self.model.b` -> self, `eng.lw[v]` -> eng."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def names_in(node: ast.AST) -> set:
    """All trailing identifiers mentioned anywhere inside `node`."""
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out
