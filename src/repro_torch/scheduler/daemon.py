"""The freshness scheduler daemon.

One background thread per server. Each loop iteration ("tick") scans the
catalog for views whose staleness is approaching their effective lag,
picks the most urgent one — (staleness / lag) damped by SKIING-modeled
catch-up cost — and refreshes it (plus any stale ancestors, in
topological order) inside ONE exclusive slice of the executor's epoch
gate. Short slices keep the p99 of concurrent point reads bounded: the
gate is held per refresh, not per scan.

The daemon is deliberately dumb about time: it reads `self.clock`
(defaults to the catalog's clock) and exposes a synchronous `tick(now)`
so tests drive it with a modeled clock and assert the schedule
deterministically — same stream + same lags ⇒ same `schedule_log`.
"""
from __future__ import annotations

import logging
import threading
from typing import List, Optional, Tuple

from repro_torch.scheduler import refresh as fr

logger = logging.getLogger(__name__)

#: refresh when staleness has consumed this fraction of the target lag —
#: scheduling AT the deadline would mean every refresh lands late by one
#: slice; half-lag headroom keeps measured staleness ≤ lag.
HEADROOM = 0.5


class FreshnessScheduler:
    """Background refresher maintaining views to their `target_lag`."""

    def __init__(self, executor, *, interval: float = 0.05,
                 headroom: float = HEADROOM, clock=None):
        self.executor = executor
        self.catalog = executor.catalog
        self.clock = clock if clock is not None else self.catalog.clock
        self.interval = float(interval)
        self.headroom = float(headroom)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: (tick index, names refreshed) — the determinism tests' witness
        self.schedule_log: List[Tuple[int, Tuple[str, ...]]] = []
        self.ticks = 0
        m = executor.metrics
        self._m_ticks = m.counter("scheduler.ticks")
        self._m_slices = m.counter("scheduler.slices")
        self._m_refreshes = m.counter("scheduler.refreshes")
        self._m_rows = m.counter("scheduler.rows_applied")

    # -- scheduling policy ------------------------------------------------

    def due(self, now: float):
        """Views worth refreshing now: scheduler-managed, not suspended,
        not starved by a suspended ancestor, staleness past the headroom
        fraction of their effective lag. Catalog topological order —
        stable, so ties break deterministically."""
        out = []
        for vd in self.catalog.topo_order():
            rt = vd.runtime
            if rt.suspended:
                continue
            lag = self.catalog.effective_lag(vd.name)
            if lag is None:
                continue
            if rt.stale_since is None:
                continue
            if fr.upstream_blocked(self.catalog, vd):
                continue
            if rt.staleness(now) >= self.headroom * lag:
                out.append(vd)
        return out

    def tick(self, now: Optional[float] = None) -> List[str]:
        """One scheduling decision: pick the highest-priority due view,
        refresh it (ancestors first) under an exclusive gate slice.
        Synchronous and clock-injectable — the unit tests call this
        directly; the daemon thread calls it in a loop."""
        now = self.clock() if now is None else now
        self.ticks += 1
        self._m_ticks.inc()
        due = self.due(now)
        if not due:
            return []
        vd = max(due, key=lambda v: fr.priority(self.catalog, v, now))
        with self.executor.gate.write():
            rows_before = vd.runtime.rows_applied
            names = fr.refresh_view(self.catalog, vd, now)
        self._m_slices.inc()
        self._m_refreshes.inc(len(names))
        self._m_rows.inc(vd.runtime.rows_applied - rows_before)
        self.schedule_log.append((self.ticks, tuple(names)))
        return names

    # -- daemon lifecycle -------------------------------------------------

    def start(self) -> "FreshnessScheduler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="freshness-scheduler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                refreshed = self.tick()
            except Exception:          # pragma: no cover - defensive
                logger.exception("freshness scheduler tick failed")
                refreshed = []
            if not refreshed:
                # nothing due: sleep one interval (wakes early on stop)
                self._stop.wait(self.interval)
