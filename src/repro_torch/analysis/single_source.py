"""SRC — the single-source-rule pass.

Every algorithm rule lives exactly once in `core/engine.py` (the
contract `tests/test_engine_core.py` pins by import identity for the
shells). This pass generalizes it repo-wide by looking for
RE-DERIVATIONS of those rules — the raw arithmetic — outside engine.py:

    SRC001  Lemma 3.1 band / Eq. 2 waters logic re-derived: a
            comparison whose operand is an eps/waters bound (`lw`, `hw`,
            anything named `*water*`), e.g. `eps >= hw`, `eps < lw`,
            band masks like `(eps >= lw) & (eps < hw)` — or a
            `searchsorted` probing a sorted-eps array AT a waters bound.
            Use `band_partition` / `probe_partition` / `band_mask` /
            `waters_update` instead.
    SRC002  SKIING charging re-derived: accumulator arithmetic
            (`acc += cost`, `acc = acc + ...`) or a reorganization
            trigger comparing the accumulator (`acc >= alpha * S`).
            Use `skiing_charge` / `skiing_due` instead.

Passing bounds *through* to the engine rules is of course fine:
`band_partition(eps, lw, hw)` mentions `lw`/`hw` as call arguments,
not comparison operands. `_topk_from_sorted`'s `searchsorted(eps_sorted,
c - slack)` probes at a top-margin cutoff, not a waters bound — only
probes whose NEEDLE references a bound are findings.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List

from repro_torch.analysis.common import (Finding, ModuleSet, names_in,
                                   trailing_name)

_BOUND_NAMES = {"lw", "hw"}
_ACC_NAMES = {"acc"}


def _is_bound(node: ast.AST) -> bool:
    name = trailing_name(node)
    if name is None:
        return False
    return name in _BOUND_NAMES or "water" in name


def _is_engine(path: Path) -> bool:
    return path.name == "engine.py" and path.parent.name == "core"


def check_single_source(modules: ModuleSet) -> List[Finding]:
    findings: List[Finding] = []
    for path, tree in modules.trees.items():
        if _is_engine(path):
            continue
        for node in ast.walk(tree):
            # SRC001: comparisons against a waters bound
            if isinstance(node, ast.Compare):
                operands = [node.left] + list(node.comparators)
                if any(_is_bound(op) for op in operands):
                    findings.append(modules.finding(
                        path, node, "SRC001",
                        "band/waters comparison outside core/engine.py "
                        "— use band_partition/probe_partition/band_mask/"
                        "waters rules"))
                elif any(tn in _ACC_NAMES
                         for op in operands
                         if (tn := trailing_name(op)) is not None) \
                        and "alpha" in names_in(node):
                    findings.append(modules.finding(
                        path, node, "SRC002",
                        "SKIING trigger re-derived outside "
                        "core/engine.py — use skiing_due"))
            # SRC001: searchsorted probing at a waters bound
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, (ast.Attribute, ast.Name))
                  and trailing_name(node.func) == "searchsorted"):
                needles = node.args[1:] + [k.value for k in node.keywords]
                hit = {n for needle in needles for n in names_in(needle)
                       if n in _BOUND_NAMES or "water" in n}
                if hit:
                    findings.append(modules.finding(
                        path, node, "SRC001",
                        f"searchsorted at waters bound(s) "
                        f"{sorted(hit)} outside core/engine.py — use "
                        f"band_partition"))
            # SRC002: accumulator charging arithmetic
            elif isinstance(node, ast.AugAssign) \
                    and trailing_name(node.target) in _ACC_NAMES:
                findings.append(modules.finding(
                    path, node, "SRC002",
                    "SKIING charge accumulation re-derived outside "
                    "core/engine.py — use skiing_charge"))
    return findings
