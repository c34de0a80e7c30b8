"""Background readahead along the eps order (`Prefetcher`), the
counterpart of `repro.storage.prefetch`.

The eps clustering order is the disk locality order (§3.5.2), so the
storage layer can predict cold reads: a band probe that misses at
eps-position p will likely be followed by probes at p+1, p+2, ...
boundary-outward. Engines enqueue entity-id schedules (band windows on a
miss, the whole eps order on reorganize) and one daemon worker streams
the pages into the pool through `BufferPool._prefetch_pages` (batched
`read_pages`, no pool lock held during the copies, placeholder frames
keeping concurrent probes coalesced).

Contract:
  * bounded queue (`max_queue` schedules; the newest is dropped when
    full — readahead is advisory, dropping it only costs a future miss);
  * budget-respecting: `evict=False` schedules stop at the pool budget
    (warm semantics), `evict=True` streams and sweeps (scan readahead);
    neither ever evicts a pinned or in-flight frame;
  * clean shutdown: `close()` sheds the queue, joins the worker and
    detaches from `pool.prefetcher`; idempotent; `drain()` waits for
    quiescence.

The worker never holds its own condition variable while calling into the
pool, so it adds no edge to the `gate < wal_commit < pool` order.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Iterable, Tuple

import numpy as np


class Prefetcher:
    """One daemon thread feeding `pool._prefetch_pages` from a bounded
    queue of (pages, evict) schedules. Attaches itself as
    `pool.prefetcher`; engines discover it with `getattr`."""

    def __init__(self, pool, *, max_queue: int = 256, batch_pages: int = 32):
        self.pool = pool
        self.max_queue = int(max_queue)
        self.batch_pages = int(batch_pages)
        self._cv = threading.Condition()
        self._queue: deque = deque()        # of (np.ndarray pages, evict)
        self._idle = threading.Event()
        self._idle.set()
        self._closed = False
        self.enqueued = 0
        self.dropped = 0                    # schedules shed on overflow
        self.errors = 0
        self._thread = threading.Thread(target=self._run,
                                        name="repro-prefetcher", daemon=True)
        self._thread.start()
        pool.prefetcher = self

    # -- producers -----------------------------------------------------
    def enqueue(self, entity_ids: Iterable[int], *, evict: bool = False):
        """Schedule the pages of `entity_ids` (first-appearance order).
        evict=False warms until the budget is full; evict=True streams
        (scan readahead). Page mapping happens on the CALLER's thread —
        `_ordered_pages` is pure and lock-free — so the worker only does
        I/O."""
        pages = self.pool._ordered_pages(entity_ids)
        if pages.size:
            self.enqueue_pages(pages, evict=evict)

    def enqueue_pages(self, pages: np.ndarray, *, evict: bool = False):
        with self._cv:
            if self._closed:
                return
            if len(self._queue) >= self.max_queue:
                self.dropped += 1           # advisory: shed, don't block
                return
            self._queue.append((pages, bool(evict)))
            self.enqueued += 1
            self._idle.clear()
            self._cv.notify()

    # -- worker --------------------------------------------------------
    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._idle.set()
                    self._cv.wait()
                if self._closed and not self._queue:
                    self._idle.set()
                    return
                pages, evict = self._queue.popleft()
            try:                            # cv released: I/O off ALL locks
                self.pool._prefetch_pages(pages, evict=evict,
                                          readahead=True,
                                          batch=self.batch_pages)
            except Exception:
                self.errors += 1            # advisory path: log-and-go

    # -- lifecycle -----------------------------------------------------
    def drain(self, timeout: float = 10.0) -> bool:
        """Block until the queue is empty and the worker is parked."""
        return self._idle.wait(timeout)

    def close(self, timeout: float = 5.0):
        """Stop the worker: shed queued schedules, join, detach."""
        with self._cv:
            self._closed = True
            self._queue.clear()
            self._cv.notify_all()
        self._thread.join(timeout)
        if getattr(self.pool, "prefetcher", None) is self:
            self.pool.prefetcher = None

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def stats(self) -> dict:
        with self._cv:
            return {
                "enqueued": self.enqueued,
                "dropped": self.dropped,
                "errors": self.errors,
                "queued": len(self._queue),
                "alive": self._thread.is_alive(),
            }
