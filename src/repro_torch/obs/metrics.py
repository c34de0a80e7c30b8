"""Thread-safe metrics primitives: counters, gauges, fixed-bucket histograms,
the counterpart of `repro.obs.metrics` (stdlib only, the same bucket edges,
quantile rule and snapshots).

One ``MetricsRegistry`` is shared by every layer that reports into it.
Instruments are get-or-create by dotted name and cheap enough to leave
armed in production: each operation is one small critical section on a
per-instrument lock (CPython ``+=`` on an int is not atomic across
bytecodes, and exact reconciliation — hits + misses == probes, commits ==
epoch — is the whole point of this layer).

Histograms use fixed upper-bound buckets (exponential time buckets by
default) with exact ``count``/``sum``; quantiles report the upper bound of
the first bucket whose cumulative count reaches ``q * count``, which makes
percentile tests exact on known distributions.

Layered snapshots: components that already keep their own locked counters
(buffer pool, prefetcher, facades, WAL) register a *collector* — a zero-arg
callable returning a JSON-able dict — and ``snapshot()`` merges them in.
Collectors run outside the registry lock, so a collector may take its
component's own lock (pool, wal_commit) without ordering hazards.
"""
from __future__ import annotations

import bisect
import threading
from typing import Any, Callable, Dict, Optional, Sequence

# Upper bucket bounds in seconds, ~1 µs .. 10 s. Spans, gate waits, pool
# reads and SKIING phases all land comfortably inside this range at any
# scale we run.
DEFAULT_TIME_BUCKETS: Sequence[float] = (
    1e-6, 2.5e-6, 5e-6,
    1e-5, 2.5e-5, 5e-5,
    1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1,
    1.0, 2.5, 5.0, 10.0,
)

# Upper bounds for count-like distributions (WAL group sizes, batch sizes).
DEFAULT_COUNT_BUCKETS: Sequence[float] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096,
)


class Counter:
    """Monotonic counter. ``inc`` is a single locked add."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins scalar (queue depths, sizes)."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v


class Histogram:
    """Fixed-bucket histogram with exact count/sum.

    ``bounds`` are inclusive upper bucket edges; observations above the last
    bound land in an overflow bucket whose quantile reports ``inf``.
    """

    __slots__ = ("_lock", "bounds", "counts", "count", "sum")

    def __init__(self, bounds: Sequence[float] = DEFAULT_TIME_BUCKETS) -> None:
        self._lock = threading.Lock()
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # +1 overflow
        self.count = 0
        self.sum = 0.0

    def observe(self, x: float) -> None:
        i = bisect.bisect_left(self.bounds, x)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += x

    def quantile(self, q: float) -> float:
        """Upper bound of the first bucket whose cumulative count reaches
        ``q * count``. Exact for distributions aligned to bucket edges."""
        with self._lock:
            total = self.count
            counts = list(self.counts)
        if total == 0:
            return 0.0
        target = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                return self.bounds[i] if i < len(self.bounds) else float("inf")
        return float("inf")

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            count, total = self.count, self.sum
            counts = list(self.counts)
        snap: Dict[str, Any] = {
            "count": count,
            "sum": total,
            "mean": (total / count) if count else 0.0,
            "buckets": list(self.bounds),
            "counts": counts,
        }
        # p50/p99 recomputed from the copied counts so the snapshot is
        # internally consistent even under concurrent observes.
        for name, q in (("p50", 0.50), ("p99", 0.99)):
            if count == 0:
                snap[name] = 0.0
                continue
            target, cum, val = q * count, 0, float("inf")
            for i, c in enumerate(counts):
                cum += c
                if cum >= target:
                    val = self.bounds[i] if i < len(self.bounds) else float("inf")
                    break
            snap[name] = val
        return snap


class MetricsRegistry:
    """Process-local registry: named instruments + layered collectors."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._collectors: Dict[str, Callable[[], Any]] = {}

    # Lookups take the lock only on the create path: dict reads are atomic
    # under the GIL and instruments are never removed, so the hit path (every
    # statement, every span) is a single dict probe.

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is not None:
            return c
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is not None:
            return g
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str, buckets: Optional[Sequence[float]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is not None:
            return h
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(buckets or DEFAULT_TIME_BUCKETS)
            return h

    def register_collector(self, name: str, fn: Callable[[], Any]) -> None:
        """Attach a component snapshot under ``name``. Last writer wins, so
        re-creating a view re-points its collector instead of erroring."""
        with self._lock:
            self._collectors[name] = fn

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able point-in-time snapshot of every instrument + collector."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
            collectors = dict(self._collectors)
        out: Dict[str, Any] = {
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {n: h.snapshot() for n, h in sorted(histograms.items())},
        }
        # Collectors run outside the registry lock: they may take their own
        # component locks (pool, wal_commit) while gathering.
        for name, fn in sorted(collectors.items()):
            try:
                out[name] = fn()
            except Exception as e:  # a dead collector must not kill SHOW METRICS
                out[name] = {"error": type(e).__name__}
        return out
