"""Buffer pool: a byte-denominated memory budget over `EntityStore` pages,
the counterpart of `repro.storage.pool`, with the same behaviour line for
line (same counters, same `stats()` keys, same eviction order).

  * `get_row(id)` / `touch(id)` — the probe read path. A resident page is
    a HIT ("pool" tier: answered from memory); a non-resident page is a
    MISS ("disk" tier: one `EntityStore.read_page` cold read, then the
    page is admitted and the budget enforced by eviction).
  * eviction — clock (second-chance): a sweep clears reference bits and
    evicts the first unreferenced, UNPINNED, settled frame. Pinned and
    in-flight frames are never evicted, whatever the budget says; if
    everything is pinned the pool overcommits rather than dropping a pin.
  * pins — the §3.5.2 hot buffers are pinned pool pages. `repin_rows`
    pins the pages covering the new hot-buffer window before unpinning
    the old one, capped so pins alone never exceed the budget.
  * `warm(ids)` — prefetch pages of `ids` IN ORDER until the budget is
    full, never evicting. Reorganization calls it with the entities in
    boundary-outward eps order (the eps order IS the locality order).

Pages are CPU tensors (`EntityStore.read_page`). No page crosses to the
device: the pool serves the engines' point reads only, and an engine
classifies a row read through it on the host, against its host copy of
the model, as the reference does; the maintenance scans read the device
copies of F.

Counters reconcile by construction: hits + misses + coalesced == probes;
warming is counted as `prefetches`, background readahead as
`readahead_pages` (with `readahead_used` counting the first probe that
consumed each readahead page).

Thread safety and the asynchronous cold read: ONE reentrant lock guards
every compound invariant — (`frames`, `_clock`, `_hand`,
`resident_bytes`), the pins and the counters — but the copy out of the
map runs with NO lock held:

    miss ──▶ [lock] install placeholder Frame(data=None, latch) ──▶ [unlock]
              │                                                       │
              │  concurrent missers of the SAME page                  ▼
              └─▶ [lock] see data=None ─▶ [unlock] latch.wait()   read_page
                  (counted `coalesced`, NOT a second disk read)       │
                                                                      ▼
              [lock] publish data into the frame, evict to budget ──▶ latch.set()

A placeholder charges `resident_bytes` when it is installed, so the
budget never undercounts reads in flight; the clock sweep skips
`data is None` frames like pinned ones. If the read fails, the
placeholder is removed, the error is stored on the frame, and every
waiter re-raises it. Waiters keep the frame object, so a page evicted
between publish and wake-up still hands them its data.

`EntityStore.read_page` / `read_pages` assert, under
`REPRO_LOCK_WITNESS=1`, that the calling thread does not hold the pool
lock; `repro.analysis` LCK004 proves the same statically.

Background readahead lives in `repro_torch.storage.prefetch.Prefetcher`,
which feeds `_prefetch_pages` from its own thread; `pool.prefetcher` is
the attachment point the engines probe for.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.witness import wrap
from repro_torch.obs.trace import span as _span
from repro_torch.storage.store import EntityStore

#: placeholder frames installed per lock hold by the batched prefetch
#: path — bounds both lock hold time and the transient overshoot of the
#: evicting (streaming-readahead) mode to one batch of pages.
LOAD_BATCH_PAGES = 64


@dataclasses.dataclass
class Frame:
    data: Optional[torch.Tensor]  # (rows, d) f32 on the CPU; None = IN FLIGHT
    nbytes: int                 # page size, charged to the budget at install
    pin_count: int = 0
    ref: bool = True            # clock reference bit
    latch: Optional[threading.Event] = None   # set when the load settles
    error: Optional[BaseException] = None     # loader failure, for waiters
    readahead: bool = False     # loaded by the Prefetcher, not yet consumed


class BufferPool:
    def __init__(self, store: EntityStore, budget_bytes: int, *, metrics=None):
        self.store = store
        # the pool must be able to hold at least one page
        self.budget_bytes = max(int(budget_bytes), store.page_bytes)
        # optional MetricsRegistry: cold-read spans record into
        # span.pool.read.seconds; counters stay local (see stats()).
        self._metrics = metrics
        # reentrant: repin_rows -> pin_rows -> install helpers all hold it
        self._lock = wrap(threading.RLock(), "pool")
        self.frames: Dict[int, Frame] = {}
        self._clock: List[int] = []                # page ids, clock order
        self._hand = 0
        self.resident_bytes = 0
        self.hits = 0
        self.misses = 0
        self.coalesced = 0          # probes that waited on another's read
        self.in_flight = 0          # gauge: placeholder frames outstanding
        self.evictions = 0
        self.prefetches = 0         # warm()/pin fault-ins
        self.readahead_pages = 0    # pages loaded by the Prefetcher
        self.readahead_used = 0     # readahead pages a probe then consumed
        self._hot_pins: List[int] = []             # pages pinned for hot buffers
        self.prefetcher = None      # Prefetcher attaches itself here

    # -- read path -----------------------------------------------------
    @property
    def probes(self) -> int:
        return self.hits + self.misses + self.coalesced

    def resident(self, entity_id: int) -> bool:
        with self._lock:
            return int(self.store.dir_page[entity_id]) in self.frames

    def touch(self, entity_id: int) -> Tuple[torch.Tensor, str]:
        """Read one entity row; returns (row, "pool"|"disk")."""
        data, how = self._page(int(self.store.dir_page[entity_id]))
        return data[int(self.store.dir_slot[entity_id])], how

    def get_row(self, entity_id: int) -> torch.Tensor:
        return self.touch(entity_id)[0]

    def _page(self, pid: int) -> Tuple[torch.Tensor, str]:
        """Resolve one page: hit, coalesced wait, or loader miss. The cold
        `read_page` copy runs with NO lock held (see the module doc)."""
        while True:
            with self._lock:
                fr = self.frames.get(pid)
                if fr is None:
                    fr = self._install_placeholder(pid)
                    self.misses += 1
                    latch = fr.latch
                    break                          # -> loader path below
                fr.ref = True
                if fr.readahead:
                    fr.readahead = False
                    self.readahead_used += 1
                if fr.data is not None:
                    self.hits += 1
                    return fr.data, "pool"
                self.coalesced += 1                # someone else is reading
                latch = fr.latch
            latch.wait()                           # park OFF the lock
            if fr.error is not None:
                raise fr.error
            if fr.data is not None:                # frame object outlives
                return fr.data, "disk"             # any eviction race
            # loader dropped the frame without data or error: retry
        try:
            with _span("pool.read", metrics=self._metrics, pages=1):
                data = self.store.read_page(pid)   # THE cold read, unlocked
        except BaseException as e:
            with self._lock:
                fr.error = e
                self._drop_inflight(pid, fr)
            latch.set()
            raise
        with self._lock:
            self._publish(pid, fr, data)
            self._evict_to_budget()
        latch.set()
        return data, "disk"

    # -- admission / eviction (helpers suffixed-by-contract: callers hold
    # the pool lock; none of them block) -------------------------------
    def _install_placeholder(self, pid: int) -> Frame:
        fr = Frame(None, self.store.page_nbytes(pid),
                   latch=threading.Event())
        self.frames[pid] = fr
        self._clock.append(pid)
        self.resident_bytes += fr.nbytes           # charged while in flight
        self.in_flight += 1
        return fr

    def _publish(self, pid: int, fr: Frame, data: torch.Tensor):
        fr.data = data
        fr.ref = True
        self.in_flight = max(0, self.in_flight - 1)

    def _drop_inflight(self, pid: int, fr: Frame):
        """Remove a placeholder whose read failed (waiters re-raise via
        `fr.error`; the frame object keeps carrying it after removal)."""
        if self.frames.get(pid) is fr:
            del self.frames[pid]
            self._clock.remove(pid)
            if self._hand >= len(self._clock):
                self._hand = 0
            self.resident_bytes -= fr.nbytes
        self.in_flight = max(0, self.in_flight - 1)

    def _evict_to_budget(self):
        """Clock sweep until resident_bytes <= budget or nothing is
        evictable (pinned/in-flight only -> overcommit rather than drop
        a pin or rip a page out from under its loader)."""
        skipped = 0
        while self.resident_bytes > self.budget_bytes and self._clock:
            if skipped > 2 * len(self._clock):
                break                       # only pinned/in-flight left
            if self._hand >= len(self._clock):
                self._hand = 0
            pid = self._clock[self._hand]
            fr = self.frames[pid]
            if fr.pin_count > 0 or fr.data is None:
                self._hand += 1
                skipped += 1
                continue
            if fr.ref:
                fr.ref = False                      # second chance
                self._hand += 1
                skipped += 1
                continue
            del self.frames[pid]
            self._clock.pop(self._hand)             # hand now at the next frame
            self.resident_bytes -= fr.nbytes
            self.evictions += 1
            skipped = 0

    def _load_frames(self, loads: Sequence[Tuple[int, Frame]]):
        """Read + publish placeholder frames installed by THIS caller.
        One batched `read_pages` (contiguous runs collapse to single mmap
        copies), NO lock held during the I/O."""
        latches = [fr.latch for _, fr in loads]
        try:
            with _span("pool.read", metrics=self._metrics, pages=len(loads)):
                datas = self.store.read_pages([pid for pid, _ in loads])
        except BaseException as e:
            with self._lock:
                for pid, fr in loads:
                    fr.error = e
                    self._drop_inflight(pid, fr)
            for latch in latches:
                latch.set()
            raise
        with self._lock:
            for (pid, fr), data in zip(loads, datas):
                self._publish(pid, fr, data)
        for latch in latches:
            latch.set()

    # -- pins (hot buffers) --------------------------------------------
    def _ordered_pages(self, entity_ids: Iterable[int]) -> np.ndarray:
        """Unique pages of `entity_ids`, in first-appearance order. Fully
        vectorized: callers hand this the whole n-entity eps order on
        every reorganization, so any Python-loop dedup here would put an
        O(n) pass on the maintenance path. Consumers iterate the result
        lazily and break as soon as the budget is spent."""
        ids = np.asarray(entity_ids
                         if isinstance(entity_ids, np.ndarray)
                         else list(entity_ids), np.int64)
        if ids.size == 0:
            return ids
        pages = self.store.dir_page[ids]
        _, first = np.unique(pages, return_index=True)
        return pages[np.sort(first)]

    def _pinned_bytes_locked(self, exclude: Iterable[int] = ()) -> int:
        ex = set(int(p) for p in exclude)
        return sum(fr.nbytes for pid, fr in self.frames.items()
                   if fr.pin_count > 0 and pid not in ex)

    def pinned_bytes(self) -> int:
        with self._lock:
            return self._pinned_bytes_locked()

    def pin_rows(self, entity_ids: Iterable[int]) -> List[int]:
        """Pin the pages covering `entity_ids` (in first-appearance order),
        faulting absent ones in as prefetches. Pins are capped so that the
        pinned set alone never exceeds the budget (at least one page is
        always pinned if any id was given). Returns the pinned page ids."""
        return self._pin_pages(self._ordered_pages(entity_ids), exclude=())

    def _pin_pages(self, pages: np.ndarray, *,
                   exclude: Iterable[int]) -> List[int]:
        """Pin `pages` up to the budget cap, with `exclude`'s pages not
        charged against the cap (repin: the old window releases its claim).
        Absent pages are installed as PINNED placeholders under the lock
        and their reads run after the lock is released — a concurrent
        sweep can never reclaim them mid-fault."""
        with self._lock:
            budget_left = self.budget_bytes - self._pinned_bytes_locked(
                exclude)
            targets: List[int] = []
            loads: List[Tuple[int, Frame]] = []
            for pid in pages:
                pid = int(pid)
                size = self.store.page_nbytes(pid)
                if targets and size > budget_left:
                    break
                fr = self.frames.get(pid)
                if fr is None:
                    fr = self._install_placeholder(pid)
                    self.prefetches += 1
                    loads.append((pid, fr))
                fr.pin_count += 1
                fr.ref = True
                targets.append(pid)
                budget_left -= size
        if loads:
            self._load_frames(loads)
        if targets:
            with self._lock:
                self._evict_to_budget()
        return targets

    def unpin(self, page_ids: Iterable[int]):
        with self._lock:
            for pid in page_ids:
                fr = self.frames.get(pid)
                if fr is not None and fr.pin_count > 0:
                    fr.pin_count -= 1

    def repin_rows(self, entity_ids: Iterable[int]):
        """Move the hot-buffer pin set to the pages of `entity_ids`. The
        NEW window is pinned first with the OLD window's pages excluded
        from the budget cap (they release their claim at the same move,
        so a full-budget window never caps its own replacement), then the
        old pins are dropped. Overlap pages are double-pinned for the
        duration — pin_count never dips to 0 — so no concurrent sweep can
        evict them mid-move, without holding the lock across the fault-in
        reads."""
        old = self._hot_pins
        self._hot_pins = self._pin_pages(self._ordered_pages(entity_ids),
                                         exclude=old)
        self.unpin(old)
        with self._lock:
            self._evict_to_budget()

    # -- warming / readahead -------------------------------------------
    def warm(self, entity_ids: Iterable[int]):
        """Prefetch the pages of `entity_ids` IN ORDER until the budget is
        full; never evicts (already-resident pages just get a reference).
        The reads run OFF the lock in placeholder batches."""
        self._prefetch_pages(self._ordered_pages(entity_ids), evict=False)

    def _prefetch_pages(self, pages, *, evict: bool = False,
                        readahead: bool = False,
                        batch: int = LOAD_BATCH_PAGES) -> int:
        """Load absent pages IN ORDER: `batch` placeholders installed per
        lock hold, then one batched read with no lock held. evict=False
        stops at the budget (warm semantics); evict=True keeps streaming
        and sweeps after each batch (scan readahead — transient overshoot
        bounded by one batch). Returns the number of pages loaded."""
        pages = [int(p) for p in np.asarray(pages).ravel()]
        batch = max(1, min(int(batch),
                           self.budget_bytes // self.store.page_bytes or 1))
        loaded, i, full = 0, 0, False
        while i < len(pages) and not full:
            loads: List[Tuple[int, Frame]] = []
            with self._lock:
                while i < len(pages) and len(loads) < batch:
                    pid = pages[i]
                    fr = self.frames.get(pid)
                    if fr is not None:
                        fr.ref = True
                        i += 1
                        continue
                    size = self.store.page_nbytes(pid)
                    if not evict and (self.resident_bytes + size
                                      > self.budget_bytes):
                        full = True                # budget full: stop, but
                        break                      # still load this batch
                    fr = self._install_placeholder(pid)
                    if readahead:
                        fr.readahead = True
                        self.readahead_pages += 1
                    else:
                        self.prefetches += 1
                    loads.append((pid, fr))
                    i += 1
            if loads:
                self._load_frames(loads)
                loaded += len(loads)
                if evict:
                    with self._lock:
                        self._evict_to_budget()
        return loaded

    # -- introspection -------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> dict:
        probes = self.probes
        return {
            "budget_bytes": self.budget_bytes,
            "table_bytes": self.store.nbytes,
            "page_bytes": self.store.page_bytes,
            "pages_total": self.store.num_pages,
            "pages_resident": len(self.frames),
            "resident_bytes": self.resident_bytes,
            "pinned_pages": sum(1 for fr in self.frames.values()
                                if fr.pin_count > 0),
            "hits": self.hits,
            "misses": self.misses,
            "coalesced": self.coalesced,
            "in_flight": self.in_flight,
            "evictions": self.evictions,
            "prefetches": self.prefetches,
            "readahead_pages": self.readahead_pages,
            "readahead_used": self.readahead_used,
            "readahead_hit_rate": (self.readahead_used / self.readahead_pages
                                   if self.readahead_pages else 1.0),
            "probes": probes,
            "hit_rate": self.hits / probes if probes else 1.0,
        }

    def close(self):
        """Drop every frame (the shared `EntityStore` is closed by its
        owner — several pools may share one store)."""
        with self._lock:
            self.frames.clear()
            self._clock.clear()
            self._hand = 0
            self.resident_bytes = 0
            self.in_flight = 0
            self._hot_pins = []
