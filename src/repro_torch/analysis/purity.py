"""PUR — the core-purity pass, the port's copy of `repro.analysis.purity`
with what the reference's rules cannot see in the port.

Pure steps are the functions that DECLARE an `xp` backend parameter (the
reference's Layer 2: `apply_model`, `reorganize`, `catch_up`,
`hybrid_probe`, ... — the rule is self-applying, so a fixture or a new
module claiming purity via `xp` is held to the same standard) and, in
the port, whose first parameter is annotated `EngineState` (the port's
Layer 2 steps take no `xp`: `_margins`, `reorganize`, `_relabel`,
`apply_model`, `catch_up`, `hybrid_probe` of `core/engine.py`), plus
every kernel module (`kernels/*/kernel.py`). For those:

    PUR001  direct `np.` use — the backend must come in through `xp`.
            The ONE blessed exception is a backend dispatch guarded by
            `if xp is np:` (numpy-only fast paths like stable argsort).
            Only the `xp` steps and the kernels are held to it: the
            port's `EngineState` steps keep their (k,) control fields
            numpy on the host by design (bit for bit the numpy core's
            waters), beside the bulk fields as device tensors.
    PUR002  Python side effects: `print`, `global`/`nonlocal`
            statements, `.item()` host syncs, `time.*`, `input`,
            `os.*` — a step must be a pure function of its arguments.
    PUR003  in-place mutation of a parameter (`state_arr[...] = x`,
            `param += y`, and torch's forms: a method whose name ends in
            `_` such as `param.copy_(x)` or `state.labels.index_put_(...)`,
            or an `out=param` keyword) — pure steps return new values;
            mutating an argument breaks tracing and value semantics.
            Writes to LOCAL arrays and to Pallas `*_ref` output
            references are fine.

The port's `kernels/*/kernel.py` launch hand-written CUDA through ctypes,
not Pallas; they are held to the same three rules, torch's forms
included: the wrappers allocate their outputs and pass the device
pointers to the C entry, so the writes the launch makes are not Python
statements and are not in the rules' reach.

Shells (everything outside engine.py in `core/`, `rdbms/`, `storage/`):

    PUR004  in-place mutation of an `EngineState` field on a non-`self`
            object (`state.labels[i] = y`, `eng.lw[v] = 0`, and torch's
            forms `state.labels.index_put_(...)`, `out=eng.lw`).
            `EngineState` is an immutable pytree; shells own their OWN
            mirrors (`self.lw[...] = ...` is their state, fine) but must
            never reach into an engine state they were handed. The field
            list is read from engine.py's `EngineState` class at scan
            time, not hardcoded.

A file under `src/` is placed by its directories inside its own package
(`common.package_dirs`), so the reference's tree reads as it does under
`repro.analysis`.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Set

from repro_torch.analysis.common import (Finding, ModuleSet, PKG_ROOT,
                                         package_dirs, root_name,
                                         trailing_name)

_SIDE_EFFECT_MODULES = {"time", "os", "sys"}


def _is_engine(path: Path) -> bool:
    return path.name == "engine.py" and path.parent.name == "core"


def _is_kernel(path: Path) -> bool:
    return path.name == "kernel.py" and "kernels" in path.parts


def engine_state_fields() -> Set[str]:
    """`EngineState._fields`, read from the real engine.py's AST."""
    engine = PKG_ROOT / "core" / "engine.py"
    if not engine.exists():
        return set()
    tree = ast.parse(engine.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "EngineState":
            return {item.target.id for item in node.body
                    if isinstance(item, ast.AnnAssign)
                    and isinstance(item.target, ast.Name)}
    return set()


def _pure_steps(tree: ast.Module):
    """(function, declares `xp`) of every pure step: a function with an
    `xp` parameter, or whose first parameter is annotated `EngineState`."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            ordered = args.posonlyargs + args.args
            names = [a.arg for a in ordered + args.kwonlyargs]
            if "xp" in names:
                yield node, True
            elif ordered and _annotated_state(ordered[0]):
                yield node, False


def _annotated_state(arg: ast.arg) -> bool:
    ann = arg.annotation
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value == "EngineState"
    return ann is not None and trailing_name(ann) == "EngineState"


def _in_place_call(node: ast.Call) -> Optional[ast.AST]:
    """What a torch in-place form writes: the receiver of a method whose
    name ends in one `_` (`x.copy_(y)`, `x[i].add_(y)`), or an `out=`
    keyword's value; None for any other call."""
    f = node.func
    if (isinstance(f, ast.Attribute) and f.attr.endswith("_")
            and not f.attr.startswith("__")):
        return f.value
    for kw in node.keywords:
        if kw.arg == "out":
            return kw.value
    return None


def _np_guarded_lines(fn: ast.AST) -> Set[int]:
    """Line numbers inside `if xp is np:` bodies (the blessed numpy
    fast-path dispatch) — `np.` use there is allowed."""
    lines: Set[int] = set()

    def is_xp_is_np(test: ast.AST) -> Optional[bool]:
        # returns True for `xp is np`, False for `xp is not np`
        if (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.left, ast.Name)
                and test.left.id == "xp"
                and isinstance(test.comparators[0], ast.Name)
                and test.comparators[0].id == "np"):
            if isinstance(test.ops[0], ast.Is):
                return True
            if isinstance(test.ops[0], ast.IsNot):
                return False
        return None

    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        guard = is_xp_is_np(node.test)
        if guard is None:
            continue
        branch = node.body if guard else node.orelse
        for stmt in branch:
            for sub in ast.walk(stmt):
                if hasattr(sub, "lineno"):
                    lines.add(sub.lineno)
    return lines


def _check_pure_function(modules: ModuleSet, path: Path, fn: ast.AST,
                         kernel: bool, numpy: bool = True) -> List[Finding]:
    """PUR001 (where `numpy`), PUR002 and PUR003 inside `fn`."""
    findings: List[Finding] = []
    where = "Pallas kernel" if kernel else f"pure step {fn.name!r}"
    guarded = set() if kernel else _np_guarded_lines(fn)
    args = fn.args
    params = {a.arg for a in args.args + args.kwonlyargs + args.posonlyargs}

    def mutation(tgt):
        root = root_name(tgt)
        name = trailing_name(tgt)
        if root in params and not (kernel and name
                                   and name.endswith("_ref")):
            findings.append(modules.finding(
                path, tgt, "PUR003",
                f"in-place mutation of parameter {root!r} "
                f"in {where} — return a new value"))

    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            written = _in_place_call(node)
            if written is not None:
                mutation(written)
        # PUR001: host numpy outside the xp seam
        if (numpy and isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "np"
                and node.lineno not in guarded):
            findings.append(modules.finding(
                path, node, "PUR001",
                f"direct np.{node.attr} in {where} — use the xp backend "
                f"parameter (or guard with `if xp is np:`)"))
        # PUR002: side effects
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            findings.append(modules.finding(
                path, node, "PUR002",
                f"{type(node).__name__.lower()} statement in {where}"))
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in ("print", "input"):
                findings.append(modules.finding(
                    path, node, "PUR002", f"{f.id}() call in {where}"))
            elif isinstance(f, ast.Attribute):
                if f.attr == "item":
                    findings.append(modules.finding(
                        path, node, "PUR002",
                        f".item() host sync in {where}"))
                elif (isinstance(f.value, ast.Name)
                      and f.value.id in _SIDE_EFFECT_MODULES):
                    findings.append(modules.finding(
                        path, node, "PUR002",
                        f"{f.value.id}.{f.attr}() call in {where}"))
        # PUR003: in-place parameter mutation
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for tgt in targets:
                if isinstance(tgt, (ast.Subscript, ast.Attribute)):
                    mutation(tgt)
    return findings


def check_purity(modules: ModuleSet) -> List[Finding]:
    findings: List[Finding] = []
    fields = engine_state_fields()
    shell_dirs = {"core", "rdbms", "storage"}

    for path, tree in modules.trees.items():
        kernel = _is_kernel(path)
        if kernel:
            for node in ast.walk(tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    findings.extend(_check_pure_function(
                        modules, path, node, kernel=True))
            continue
        for fn, xp in _pure_steps(tree):
            findings.extend(_check_pure_function(modules, path, fn,
                                                 kernel=False, numpy=xp))
        # PUR004: shells mutating EngineState fields on non-self objects.
        # Applies to core/rdbms/storage modules (engine.py excepted) and
        # to out-of-tree files (the fixture corpus simulates shells);
        # models/launch/data are not EngineState shells.
        if _is_engine(path):
            continue
        rel_parts = package_dirs(path)     # None outside src/: a shell
        if rel_parts is not None and not (shell_dirs & set(rel_parts)):
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                targets = [_in_place_call(node)]
            elif isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            else:
                continue
            for tgt in targets:
                if tgt is None:
                    continue
                base = tgt.value if isinstance(tgt, ast.Subscript) else tgt
                if not isinstance(base, ast.Attribute):
                    continue
                if base.attr in fields and root_name(base) != "self":
                    findings.append(modules.finding(
                        path, tgt, "PUR004",
                        f"shell mutates EngineState field "
                        f"{base.attr!r} on {root_name(base)!r} — "
                        f"EngineState is immutable; go through an "
                        f"engine rule / _replace"))
    return findings
