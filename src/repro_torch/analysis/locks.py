"""LCK — the lock-order pass over `repro_torch.rdbms` /
`repro_torch.storage`, the port's copy of `repro.analysis.locks`.

The three system locks and their declared partial order (the runtime
witness in `repro_torch.analysis.witness` enforces the same table live):

    gate (0)        `EpochGate.read()/.write()` — acquired via
                    `with <...>gate.read():` / `.write()`; NOT reentrant.
    wal_commit (1)  `UpdateLog._commit_lock` — any `._commit_lock`
                    attribute; RLock, self-reacquisition legal
                    (`append` -> `flush`).
    pool (2)        `BufferPool._lock` — any `._lock` attribute in the
                    scanned packages (the only `._lock` there is the
                    pool's); RLock, self-reacquisition legal
                    (`repin_rows` -> `pin_rows` -> `_admit`).

Rules:

    LCK001  order inversion — acquiring a lower-level lock (directly or
            transitively through resolved calls) while a higher-level
            one is held, or re-entering the non-reentrant gate.
    LCK002  bare `.acquire()` on a known lock without the
            acquire/try/finally-release shape (`with` is the blessed
            form).
    LCK003  a blocking operation while holding the POOL lock: `open()`,
            `os.fsync`/`os.read`/`os.write`, `time.sleep`, file-handle
            `.write()`/`.flush()`/`.read()`/`.seek()`, socket
            send/recv/accept/connect, or a `.wait()` on any condition —
            the pool lock is the innermost, hottest lock; parking on it
            stalls every concurrent probe.
    LCK004  disk I/O under the pool lock: `.read_page()`/`.read_pages()`
            (the `EntityStore` cold-read surface — matched by attribute
            name, wherever the receiver came from) called, directly or
            transitively, while the pool lock is held. The async read
            path (pool.py's latch/in-flight protocol) exists precisely
            so every cold mmap copy runs OFF that lock; re-inlining one
            is a build error here and a `LockOrderError` under the
            armed witness (`EntityStore` calls
            `witness.assert_unlocked("pool", ...)` before each copy).

Acquisition is resolved through helpers with the typed-receiver call
graph (`repro_torch.analysis.callgraph`), so `repin_rows` holding the pool
lock "sees" everything `pin_rows` and `_admit` may do.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.callgraph import CallGraph, FunctionInfo
from repro_torch.analysis.common import Finding, ModuleSet, trailing_name
from repro_torch.analysis.witness import LOCK_ORDER, REENTRANT

_FILE_HANDLES = {"_fh", "fh"}
_FILE_OPS = {"write", "flush", "read", "seek", "truncate"}
_SOCKET_OPS = {"sendall", "send", "recv", "accept", "connect", "listen"}
_OS_BLOCKING = {"fsync", "fdatasync", "read", "write", "sendfile"}


def _lock_of(expr: ast.AST, graph: CallGraph) -> Optional[str]:
    """The lock id a `with`-item context expression acquires, if any."""
    if isinstance(expr, ast.Attribute):
        if expr.attr == "_commit_lock":
            return "wal_commit"
        if expr.attr == "_lock":
            return "pool"
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute):
        if expr.func.attr in ("read", "write"):
            recv = trailing_name(expr.func.value)
            if recv == "gate" or graph.receiver_types.get(recv) == "EpochGate":
                return "gate"
    return None


def _lock_of_method_call(call: ast.Call,
                         graph: CallGraph) -> Optional[Tuple[str, str]]:
    """(lock_id, method) for `.acquire()`/`.release()` on a known lock."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in ("acquire", "release"):
        lock = _lock_of(f.value, graph)
        if lock is not None:
            return lock, f.attr
    return None


def _blocking_op(call: ast.Call) -> Optional[Tuple[str, str]]:
    """(rule, descriptor) if `call` is a known blocking primitive under
    the pool lock, else None. LCK004 tags the disk-read surface, LCK003
    every other blocking primitive — the rule id rides the effect sets
    through the call-graph fixpoint so via-callee findings keep it."""
    f = call.func
    if isinstance(f, ast.Name) and f.id == "open":
        return ("LCK003", "open()")
    if isinstance(f, ast.Attribute):
        recv = trailing_name(f.value)
        if f.attr in ("read_page", "read_pages"):
            # matched by NAME: the only read_page/read_pages surface in
            # the scanned packages is the EntityStore cold read, and
            # receiver-type resolution is too coarse to rely on here
            return ("LCK004", f"{recv or '<expr>'}.{f.attr}() disk page "
                              f"read")
        if recv == "os" and f.attr in _OS_BLOCKING:
            return ("LCK003", f"os.{f.attr}()")
        if recv == "time" and f.attr == "sleep":
            return ("LCK003", "time.sleep()")
        if recv in _FILE_HANDLES and f.attr in _FILE_OPS:
            return ("LCK003", f"{recv}.{f.attr}() file I/O")
        if recv is not None and "sock" in recv and f.attr in _SOCKET_OPS:
            return ("LCK003", f"{recv}.{f.attr}() socket I/O")
        if f.attr == "wait":
            return ("LCK003", f"{recv}.wait()")
    return None


def check_locks(modules: ModuleSet, graph: CallGraph) -> List[Finding]:
    findings: List[Finding] = []

    # -- per-function direct effect sets -------------------------------
    direct_acquires: Dict[str, Set[str]] = {}
    direct_blocks: Dict[str, Set[Tuple[str, str]]] = {}   # (rule, op)
    for qual, info in graph.functions.items():
        acq: Set[str] = set()
        blk: Set[Tuple[str, str]] = set()
        for node in ast.walk(info.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lock = _lock_of(item.context_expr, graph)
                    if lock is not None:
                        acq.add(lock)
            elif isinstance(node, ast.Call):
                lm = _lock_of_method_call(node, graph)
                if lm is not None and lm[1] == "acquire":
                    acq.add(lm[0])
                op = _blocking_op(node)
                if op is not None:
                    blk.add(op)
        direct_acquires[qual] = acq
        direct_blocks[qual] = blk

    may_acquire = graph.fixpoint(direct_acquires)
    may_block = graph.fixpoint(direct_blocks)

    # -- walk each function with the held-lock stack -------------------
    for info in graph.functions.values():
        findings.extend(_walk_function(info, graph, may_acquire,
                                       may_block, modules))
    return findings


def _check_acquire(lock: str, held: List[Tuple[str, int]], node: ast.AST,
                   info: FunctionInfo, modules: ModuleSet,
                   via: Optional[str] = None) -> List[Finding]:
    out = []
    suffix = f" (via call to {via})" if via else ""
    for held_lock, held_line in held:
        if LOCK_ORDER[held_lock] > LOCK_ORDER[lock]:
            out.append(modules.finding(
                info.path, node, "LCK001",
                f"lock-order inversion: acquires {lock!r} (level "
                f"{LOCK_ORDER[lock]}) while holding {held_lock!r} (level "
                f"{LOCK_ORDER[held_lock]}, taken at line {held_line})"
                f"{suffix}"))
        elif held_lock == lock and lock not in REENTRANT:
            out.append(modules.finding(
                info.path, node, "LCK001",
                f"non-reentrant {lock!r} reacquired while already held "
                f"(taken at line {held_line}){suffix}"))
    return out


def _walk_function(info: FunctionInfo, graph: CallGraph,
                   may_acquire: Dict[str, Set[str]],
                   may_block: Dict[str, Set[Tuple[str, str]]],
                   modules: ModuleSet) -> List[Finding]:
    findings: List[Finding] = []

    def pool_held(held):
        return next((ln for lk, ln in held if lk == "pool"), None)

    def visit(node: ast.AST, held: List[Tuple[str, int]]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not info.node:
            return                     # nested defs are separate functions
        if isinstance(node, (ast.With, ast.AsyncWith)):
            locks_here = []
            for item in node.items:
                lock = _lock_of(item.context_expr, graph)
                if lock is not None:
                    findings.extend(_check_acquire(
                        lock, held, item.context_expr, info, modules))
                    locks_here.append((lock, node.lineno))
                else:
                    # non-lock context (e.g. `with open(...)`): its
                    # expression can itself block under an outer lock
                    visit(item.context_expr, held + locks_here)
            for child in node.body:
                visit(child, held + locks_here)
            return
        if isinstance(node, ast.Call):
            lm = _lock_of_method_call(node, graph)
            if lm is not None and lm[1] == "acquire":
                findings.extend(_check_acquire(lm[0], held, node, info,
                                               modules))
                if not _acquire_release_shape(node, info):
                    findings.append(modules.finding(
                        info.path, node, "LCK002",
                        f"bare .acquire() of {lm[0]!r} without the "
                        f"try/finally release shape — use `with`"))
            rule_op = _blocking_op(node)
            pl = pool_held(held)
            if rule_op is not None and pl is not None:
                rule, op = rule_op
                findings.append(modules.finding(
                    info.path, node, rule,
                    f"blocking operation {op} while holding the pool "
                    f"lock (taken at line {pl})"))
            for callee in set(graph.callees_of_call(info, node)):
                for lock in sorted(may_acquire[callee.qualname]):
                    findings.extend(_check_acquire(
                        lock, held, node, info, modules,
                        via=callee.qualname))
                if pl is not None:
                    for rule, op in sorted(may_block[callee.qualname]):
                        findings.append(modules.finding(
                            info.path, node, rule,
                            f"blocking operation {op} reachable via "
                            f"{callee.qualname} while holding the pool "
                            f"lock (taken at line {pl})"))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for child in ast.iter_child_nodes(info.node):
        visit(child, [])
    return findings


def _acquire_release_shape(call: ast.Call, info: FunctionInfo) -> bool:
    """True iff `call` (a lock `.acquire()`) is paired with a
    try/finally `.release()`: either the statement right before a Try
    whose finalbody releases, or inside such a Try's body."""
    target = trailing_name(call.func.value)

    def releases(try_node: ast.Try) -> bool:
        for stmt in try_node.finalbody:
            for sub in ast.walk(stmt):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "release"
                        and trailing_name(sub.func.value) == target):
                    return True
        return False

    for node in ast.walk(info.node):
        if not isinstance(node, ast.Try) or not releases(node):
            continue
        # inside the guarded try body?
        for stmt in node.body:
            if any(sub is call for sub in ast.walk(stmt)):
                return True
    # statement immediately preceding a guarded Try
    for node in ast.walk(info.node):
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        for i, stmt in enumerate(body[:-1]):
            if any(sub is call for sub in ast.walk(stmt)):
                nxt = body[i + 1]
                if isinstance(nxt, ast.Try) and releases(nxt):
                    return True
    return False
