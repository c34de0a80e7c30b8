"""Runtime lock-order witness (`REPRO_LOCK_WITNESS=1`), the counterpart of
`repro.analysis.witness` with the same lock ids and order.

The static pass (`repro.analysis.locks`, which also scans this package)
proves the declared partial order over the three system locks at rest;
this module asserts it live, under real scheduling. The declared order:

    gate (EpochGate, level 0)  <  wal_commit (UpdateLog._commit_lock,
    level 1)  <  pool (BufferPool._lock, level 2)

i.e. a thread holding a higher-level lock must never acquire a
lower-level one. Same-level reacquisition is allowed for the two RLocks
(`wal_commit`, `pool`) and is a violation for the gate, which is
deliberately NOT reentrant.

Zero overhead when off: `wrap()` returns the raw lock unless the witness
is active at construction time. When active, every acquisition pushes
onto a per-thread stack and the order is checked before blocking — the
witness reports the inversion instead of deadlocking on it.

Stdlib only, so `repro_torch.storage` can import it without cycles.
"""
from __future__ import annotations

import contextlib
import os
import threading

#: lock id -> level in the declared partial order (acquire upward only).
LOCK_ORDER = {"gate": 0, "wal_commit": 1, "pool": 2}

#: lock ids that may be reacquired by the holding thread (RLocks).
REENTRANT = frozenset({"wal_commit", "pool"})


class LockOrderError(AssertionError):
    """A thread acquired the three system locks out of declared order."""


class _Witness:
    """Per-thread acquisition stacks + the live order assertion."""

    def __init__(self):
        self.enabled = os.environ.get("REPRO_LOCK_WITNESS") == "1"
        self._tls = threading.local()

    @property
    def active(self) -> bool:
        return self.enabled

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def held(self) -> list:
        """The current thread's held lock ids, acquisition order."""
        return [lock_id for lock_id, _, _ in self._stack()]

    def push(self, lock_id: str, obj: object):
        """Record an acquisition about to happen; raise on inversion.
        Called BEFORE the underlying acquire blocks, so an inversion is a
        `LockOrderError` naming the held stack, not a deadlock."""
        stack = self._stack()
        level = LOCK_ORDER[lock_id]
        for held_id, held_level, held_obj in stack:
            if held_level > level:
                raise LockOrderError(
                    f"lock-order inversion: acquiring {lock_id!r} "
                    f"(level {level}) while holding {held_id!r} "
                    f"(level {held_level}); held stack: {self.held()}")
            if (held_level == level and held_obj == id(obj)
                    and lock_id not in REENTRANT):
                raise LockOrderError(
                    f"non-reentrant {lock_id!r} reacquired by its own "
                    f"holder; held stack: {self.held()}")
        stack.append((lock_id, level, id(obj)))

    def pop(self, lock_id: str, obj: object):
        stack = self._stack()
        key = (lock_id, LOCK_ORDER[lock_id], id(obj))
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == key:
                del stack[i]
                return


#: process-wide singleton; `wrap()` consults it.
WITNESS = _Witness()


def assert_unlocked(lock_id: str, what: str):
    """Witness-armed blocking-I/O guard: raise if the CURRENT thread holds
    `lock_id` while about to run `what` (a blocking operation that must
    stay outside that lock). The live twin of the static LCK004 rule:
    `EntityStore.read_page` / `read_pages` call it. Free when the witness
    is off (one attribute check)."""
    if WITNESS.active and lock_id in WITNESS.held():
        raise LockOrderError(
            f"{what} while holding {lock_id!r}; held stack: "
            f"{WITNESS.held()}")


@contextlib.contextmanager
def enabled():
    """Force the witness on for a scope (tests). Locks must be
    *constructed* inside this scope to be wrapped — `wrap` decides at
    construction time."""
    prev = WITNESS.enabled
    WITNESS.enabled = True
    try:
        yield WITNESS
    finally:
        WITNESS.enabled = prev


class WitnessedLock:
    """Thin proxy over a Lock/RLock recording acquisitions with WITNESS;
    supports the `with` protocol and explicit acquire/release."""

    # the wrapped lock is `_inner`, not `_lock`: `repro.analysis` reads
    # any `._lock` as the pool lock, and this proxy is not a call site
    __slots__ = ("_inner", "_lock_id")

    def __init__(self, lock, lock_id: str):
        self._inner = lock
        self._lock_id = lock_id

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        WITNESS.push(self._lock_id, self._inner)
        ok = self._inner.acquire(blocking, timeout)
        if not ok:
            WITNESS.pop(self._lock_id, self._inner)
        return ok

    def release(self):
        self._inner.release()
        WITNESS.pop(self._lock_id, self._inner)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def wrap(lock, lock_id: str):
    """Wrap `lock` for witnessing iff the witness is active NOW (decided
    at construction, so the disabled path is the raw `threading` lock)."""
    if lock_id not in LOCK_ORDER:
        raise ValueError(f"unknown lock id {lock_id!r}")
    if WITNESS.active:
        return WitnessedLock(lock, lock_id)
    return lock
