"""FRS — the single-source-freshness pass (lands WITH the scheduler).

The freshness scheduler's correctness argument is topological: refreshes
replay commit batches down the view DAG in `Catalog.topo_order()`, and
every piece of per-view freshness state (`ViewRuntime`: the inbox of
committed-but-unapplied batches, the staleness / last-refresh stamps, the
SUSPEND flag) is mutated inside the scheduler's gate-exclusive refresh
section and nowhere else. A module that re-derives DAG order from the raw
edges, or flips freshness state on its own, forks those semantics
silently — labels would stop being bit-identical to the immediate replay.

    FRS001  (a) direct access to the catalog's DAG-edge attributes
            (`.upstreams` / `.downstreams`) outside `repro_torch.rdbms.catalog`
            — consume `Catalog.topo_order()` / `parents_of()` /
            `children_of()` / `subtree_of()` instead of re-deriving
            refresh order;
            (b) mutation of view freshness state (an assignment /
            aug-assignment to a `ViewRuntime` field, or an in-place call
            like `.inbox.append(...)`) outside `repro_torch.scheduler` —
            route the change through the scheduler's refresh/suspend/
            resume functions, which run under the executor's exclusive
            gate.

Exemptions: `repro_torch/scheduler/` (it IS the scheduler) for both shapes, and
`repro_torch/rdbms/catalog.py` for the edge attributes (it owns them and serves
the sanctioned accessors).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List

from repro_torch.analysis.common import Finding, ModuleSet

#: the catalog's DAG-edge attributes — owned by catalog.py.
_EDGE_ATTRS = {"upstreams", "downstreams"}

#: `ViewRuntime` fields distinctive enough to flag by name alone.
_STATE_FIELDS = {"suspended", "inbox", "stale_since", "last_refresh_at",
                 "upstream_version_seen", "batches_applied", "rows_applied"}

#: in-place mutators — `.inbox.append(...)` is as much a write as `=`.
_MUTATOR_CALLS = {"append", "extend", "clear", "insert", "pop", "remove"}


def _in_scheduler(path: Path) -> bool:
    return "scheduler" in path.parts


def _is_catalog(path: Path) -> bool:
    return path.name == "catalog.py" and "rdbms" in path.parts


def _chain_attrs(node: ast.AST) -> set:
    """Attribute names along one value chain: `vd.runtime.inbox` ->
    {runtime, inbox}."""
    out = set()
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if isinstance(node, ast.Attribute):
            out.add(node.attr)
        node = node.value
    return out


def _touches_state(node: ast.AST) -> bool:
    attrs = _chain_attrs(node)
    return bool(attrs & _STATE_FIELDS) or "runtime" in attrs


def check_freshness(modules: ModuleSet) -> List[Finding]:
    findings: List[Finding] = []
    for path, tree in modules.trees.items():
        if _in_scheduler(path):
            continue
        flagged_lines = set()

        def flag(node, message):
            key = (getattr(node, "lineno", 0), message[:24])
            if key in flagged_lines:
                return
            flagged_lines.add(key)
            findings.append(modules.finding(path, node, "FRS001", message))

        for node in ast.walk(tree):
            # (a) raw DAG-edge access — re-deriving refresh order
            if (isinstance(node, ast.Attribute)
                    and node.attr in _EDGE_ATTRS
                    and not _is_catalog(path)):
                flag(node,
                     f"direct DAG-edge access .{node.attr} outside the "
                     f"catalog — refresh order comes from "
                     f"Catalog.topo_order()/parents_of()/children_of(), "
                     f"never from the raw edges")
            # (b) freshness-state writes outside the scheduler
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, (ast.Attribute, ast.Subscript)) \
                            and _touches_state(t):
                        flag(node,
                             "freshness-state mutation outside "
                             "repro_torch.scheduler — ViewRuntime fields "
                             "change only inside the scheduler's "
                             "gate-exclusive refresh section")
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _MUTATOR_CALLS
                    and _touches_state(node.func.value)):
                flag(node,
                     f"in-place freshness-state mutation "
                     f"(.{node.func.attr}) outside repro_torch.scheduler — "
                     f"deliver batches through the scheduler's offer/"
                     f"refresh path, not by editing inboxes")
    return findings
