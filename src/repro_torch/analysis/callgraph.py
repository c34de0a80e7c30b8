"""Intra-package call graph with typed-receiver resolution.

The lock pass needs to see *through* helper calls: `UpdateLog.append`
holds the commit lock and calls `self.flush(...)`, which re-takes it;
`BufferPool.repin_rows` holds the pool lock and calls `pin_rows` ->
`_admit`. A name-only call graph would also resolve `history.append(...)`
(a list) to `UpdateLog.append` and invent lock acquisitions that never
happen, so calls are resolved by RECEIVER:

  * `name(...)`            -> functions named `name` in the same module
                              (module-level or nested helpers);
  * `self.m(...)`          -> method `m` of the enclosing class;
  * `recv.m(...)`          -> method `m` of class C only when the
                              receiver's trailing name is *typed*: some
                              scanned assignment `x.recv = C(...)` or
                              `recv = C(...)` binds that name to C;
  * anything else          -> unresolved (no edge). Conservative in the
                              direction of silence for foreign objects
                              (lists, numpy arrays, file handles) whose
                              methods shadow ours by name.

`fixpoint` then propagates per-function effect sets (locks that may be
acquired, blocking operations that may run) from callees to callers
until stable, giving each function a transitive summary the lock pass
checks against the held stack at every call site.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Iterator, List, Set, Tuple

from repro_torch.analysis.common import ModuleSet, trailing_name


@dataclasses.dataclass(eq=False)      # identity hash: used in sets
class FunctionInfo:
    qualname: str              # module:Class.method or module:func
    path: Path
    cls: str                   # enclosing class name, "" for module level
    name: str                  # bare function name
    node: ast.AST              # FunctionDef / AsyncFunctionDef
    calls: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    # calls: (receiver_kind, method). receiver_kind is "" for bare-name
    # calls, "self" for self calls, else the receiver's trailing name.


def _call_sites(fn: ast.AST) -> List[Tuple[str, str]]:
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name):
            out.append(("", f.id))
        elif isinstance(f, ast.Attribute):
            recv = trailing_name(f.value)
            if recv is not None:
                out.append((recv, f.attr))
    return out


class CallGraph:
    def __init__(self, modules: ModuleSet):
        self.modules = modules
        self.functions: Dict[str, FunctionInfo] = {}
        self.by_name: Dict[str, List[FunctionInfo]] = {}
        self.methods: Dict[Tuple[str, str], List[FunctionInfo]] = {}
        #: receiver trailing name -> class name, inferred from scanned
        #: `<target> = ClassName(...)` assignments.
        self.receiver_types: Dict[str, str] = {}
        for path, tree in modules.trees.items():
            self._collect(path, tree)

    # -- construction --------------------------------------------------
    def _collect(self, path: Path, tree: ast.Module):
        mod = path.stem

        def add(fn: ast.AST, cls: str, prefix: str):
            qual = f"{mod}:{prefix}{fn.name}"
            info = FunctionInfo(qual, path, cls, fn.name, fn,
                                _call_sites(fn))
            self.functions[qual] = info
            self.by_name.setdefault(fn.name, []).append(info)
            if cls:
                self.methods.setdefault((cls, fn.name), []).append(info)
            for sub in ast.walk(fn):
                if (sub is not fn and isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef))):
                    # nested helpers resolve as bare-name calls
                    nested = FunctionInfo(f"{qual}.{sub.name}", path, cls,
                                          sub.name, sub, _call_sites(sub))
                    self.functions[nested.qualname] = nested
                    self.by_name.setdefault(sub.name, []).append(nested)

        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                add(node, "", "")
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        add(item, node.name, f"{node.name}.")

        classes = {n.name for n in ast.walk(tree)
                   if isinstance(n, ast.ClassDef)}
        self._known_classes = getattr(self, "_known_classes", set())
        self._known_classes |= classes
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                ctor = node.value.func
                cname = (ctor.id if isinstance(ctor, ast.Name)
                         else ctor.attr if isinstance(ctor, ast.Attribute)
                         else None)
                if cname is None:
                    continue
                for tgt in node.targets:
                    recv = trailing_name(tgt)
                    if recv:
                        self.receiver_types[recv] = cname

    # -- resolution ----------------------------------------------------
    def _resolve(self, info: FunctionInfo, recv: str,
                 meth: str) -> Iterator[FunctionInfo]:
        if recv == "":
            for cand in self.by_name.get(meth, []):
                if cand.path == info.path:
                    yield cand
        elif recv in ("self", "cls"):
            yield from self.methods.get((info.cls, meth), [])
        else:
            cname = self.receiver_types.get(recv)
            if cname is not None:
                yield from self.methods.get((cname, meth), [])

    def callees(self, info: FunctionInfo) -> Iterator[FunctionInfo]:
        for recv, meth in info.calls:
            yield from self._resolve(info, recv, meth)

    def callees_of_call(self, info: FunctionInfo,
                        call: ast.Call) -> Iterator[FunctionInfo]:
        """Resolve ONE call node (same receiver rules as `callees`)."""
        f = call.func
        if isinstance(f, ast.Name):
            yield from self._resolve(info, "", f.id)
        elif isinstance(f, ast.Attribute):
            recv = trailing_name(f.value)
            if recv is not None:
                yield from self._resolve(info, recv, f.attr)

    def fixpoint(self, direct: Dict[str, Set]) -> Dict[str, Set]:
        """Propagate effect sets callee -> caller until stable.
        `direct[qualname]` holds a function's own effects; the result
        adds everything reachable through resolved calls."""
        summary = {q: set(direct.get(q, ())) for q in self.functions}
        changed = True
        while changed:
            changed = False
            for qual, info in self.functions.items():
                for callee in self.callees(info):
                    extra = summary[callee.qualname] - summary[qual]
                    if extra:
                        summary[qual] |= extra
                        changed = True
        return summary
