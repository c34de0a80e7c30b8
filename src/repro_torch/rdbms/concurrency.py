"""Epoch gate: statement-scoped snapshot isolation for the SQL layer.

The engines maintain ONE mutable state in place (clustered labels, waters,
buffer windows) — there is no version chain to read from, so snapshot
isolation is enforced by *scheduling*, not by copying state:

  * epoch       == the committed WAL batch index (`UpdateLog.commits`).
  * a reader    pins the epoch at statement start by holding the gate in
                shared mode for the statement's duration; the engine state
                it reads is exactly the epoch-E state throughout, because
                nothing that advances the epoch can run concurrently.
  * a writer    (group commit, UPDATE MODEL, DDL, catch-up-capable reads)
                holds the gate exclusively: it waits behind every in-flight
                pinned read, runs alone, advances the epoch, and releases.

Writer preference: once a commit is waiting, new readers queue behind it.
A 95/5 read-heavy swarm would otherwise starve the group commit forever —
and with it every session's read-your-writes flush.

The gate is deliberately NOT reentrant across modes; the executor keeps a
thread-local depth counter so nested statement dispatch (EXECUTE ->
SELECT) runs inside the guard already held.
"""
from __future__ import annotations

import contextlib
import threading

from repro_torch.analysis.witness import WITNESS
from repro_torch.obs import clock


class EpochGate:
    """Shared/exclusive gate with writer preference (see module doc)."""

    def __init__(self, metrics=None):
        self._cv = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        # pre-resolved instruments so the hot path never does a registry
        # name lookup; wait time is observed AFTER the cv is released.
        if metrics is not None:
            self._m_shared = metrics.counter("gate.shared_acquisitions")
            self._m_excl = metrics.counter("gate.exclusive_acquisitions")
            self._m_shared_wait = metrics.histogram("gate.shared_wait_seconds")
            self._m_excl_wait = metrics.histogram("gate.exclusive_wait_seconds")
        else:
            self._m_shared = self._m_excl = None
            self._m_shared_wait = self._m_excl_wait = None

    @contextlib.contextmanager
    def read(self):
        """Hold shared for a statement-scoped snapshot-pinned read."""
        # witness seam: check the declared order BEFORE blocking, so an
        # inversion surfaces as LockOrderError, not a deadlock.
        if WITNESS.active:
            WITNESS.push("gate", self)
        try:
            t0 = clock() if self._m_shared is not None else 0.0
            with self._cv:
                while self._writer or self._writers_waiting:
                    self._cv.wait()
                self._readers += 1
            if self._m_shared is not None:
                self._m_shared.inc()
                self._m_shared_wait.observe(clock() - t0)
            try:
                yield
            finally:
                with self._cv:
                    self._readers -= 1
                    if self._readers == 0:
                        self._cv.notify_all()
        finally:
            WITNESS.pop("gate", self)

    @contextlib.contextmanager
    def write(self):
        """Hold exclusive for anything that may advance the epoch or
        mutate engine state non-idempotently."""
        if WITNESS.active:
            WITNESS.push("gate", self)
        try:
            t0 = clock() if self._m_excl is not None else 0.0
            with self._cv:
                self._writers_waiting += 1
                try:
                    while self._writer or self._readers:
                        self._cv.wait()
                finally:
                    self._writers_waiting -= 1
                self._writer = True
            if self._m_excl is not None:
                self._m_excl.inc()
                self._m_excl_wait.observe(clock() - t0)
            try:
                yield
            finally:
                with self._cv:
                    self._writer = False
                    self._cv.notify_all()
        finally:
            WITNESS.pop("gate", self)

    # -- introspection (tests) -----------------------------------------
    @property
    def readers(self) -> int:
        return self._readers

    @property
    def write_held(self) -> bool:
        return self._writer
