"""Statement tracing: parent/child spans on the monotonic clock, the
counterpart of `repro.obs.trace` (stdlib only, the same `render_tree` text).

A span is a named interval with attributes and children. The *ambient*
current span is kept on a per-thread stack, so deep layers (WAL group
commit, buffer-pool cold reads) can attach child spans without the executor
threading a tracer handle through every call — ``start()`` parents the new
span under whatever span is current on this thread, or makes it a root.

``finish(span, metrics)`` closes the span, records its duration into the
registry histogram ``span.<name>.seconds`` when a registry is given, and
unwinds the thread-local stack *through* the span — any child left open by
an exception path is discarded rather than corrupting later statements.

Rendered trees back EXPLAIN ANALYZE, the slow-statement log, and the REPL
timing footer, so all three report the same per-phase breakdown.

A `Tracer` is the handle the view engine holds when it is armed
(`core.facade.make_sharded_facade(..., tracer=)`): its registry gets the
span histograms and the engine's counters, its anchor lays the spans on a
profiler's timeline, and `keep` holds finished trees for a short slice.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

# The single sanctioned clock of the port (TEL001: raw
# time.perf_counter()/time.time() calls outside the obs package are lint
# errors).
clock = time.perf_counter

_tls = threading.local()


def _stack() -> List["Span"]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


@dataclass(slots=True)
class Span:
    name: str
    t0: float
    t1: Optional[float] = None
    attrs: Dict[str, Any] = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)

    @property
    def duration_s(self) -> float:
        end = self.t1 if self.t1 is not None else clock()
        return max(0.0, end - self.t0)

    @property
    def duration_us(self) -> float:
        return self.duration_s * 1e6

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> Optional["Span"]:
        for s in self.walk():
            if s.name == name:
                return s
        return None

    def sum_us(self, name: str) -> float:
        """Total duration of every descendant span named ``name``."""
        return sum(s.duration_us for s in self.walk() if s.name == name)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "us": round(self.duration_us, 1)}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


def current() -> Optional[Span]:
    st = _stack()
    return st[-1] if st else None


_new_span = object.__new__


def start(name: str, **attrs: Any) -> Span:
    """Open a span as a child of this thread's current span (or a root)."""
    # Hand-rolled construction: this runs five times per statement with the
    # registry armed, so skip the dataclass __init__ frame (~25% of span
    # cost) and reuse the **attrs dict, which is already a fresh one.
    sp = _new_span(Span)
    sp.name = name
    sp.t1 = None
    sp.attrs = attrs
    sp.children = []
    st = _stack()
    if st:
        st[-1].children.append(sp)
    st.append(sp)
    sp.t0 = clock()       # last: exclude our own setup from the interval
    return sp


# span name -> "span.<name>.seconds", so the statement hot path doesn't
# rebuild the histogram key on every finish.
_hist_names: Dict[str, str] = {}


def finish(sp: Span, metrics: Any = None) -> Span:
    """Close ``sp``: stamp t1, unwind the stack through it, record duration."""
    sp.t1 = clock()
    st = _stack()
    while st:
        top = st.pop()
        if top is sp:
            break
    if metrics is not None:
        hname = _hist_names.get(sp.name)
        if hname is None:
            hname = _hist_names[sp.name] = f"span.{sp.name}.seconds"
        metrics.histogram(hname).observe(sp.duration_s)
    return sp


class span:
    """``with span(name, metrics, **attrs) as sp``: `start` on entry,
    `finish` on exit (an exception's too), the duration recorded into
    `metrics`. `Tracer.span` makes one that finishes through its tracer."""

    __slots__ = ("name", "metrics", "attrs", "sp", "tracer")

    def __init__(self, name: str, metrics: Any = None, **attrs: Any) -> None:
        self.name, self.metrics, self.attrs = name, metrics, attrs
        self.tracer: Optional["Tracer"] = None

    def __enter__(self) -> Span:
        self.sp = start(self.name, **self.attrs)
        return self.sp

    def __exit__(self, *exc: Any) -> None:
        if self.tracer is None:
            finish(self.sp, self.metrics)
        else:
            self.tracer.finish(self.sp)


class Tracer:
    """A span factory bound to one metrics registry.

    Armed in an engine (`make_sharded_facade(..., tracer=)`), it is also
    the engine's counter sink: `count` adds now, `defer` holds items whose
    count would cost a device read until `snapshot` (or `DEFER_LIMIT` of
    them) counts them all at once. It carries one clock anchor, a
    (`clock()`, `time.time_ns()`) pair taken when it is made, through which
    `epoch_ns` maps a span's stamps onto the Unix-epoch nanoseconds a
    profiler's events carry. With `keep` set, every root span it finishes
    is appended to `kept` (off at first, so a long run holds no span)."""

    DEFER_LIMIT = 4096

    def __init__(self, metrics: Any = None) -> None:
        self.metrics = metrics
        self.keep = False
        self.kept: List[Span] = []
        self.pending: Dict[str, Tuple[Callable[[list], int], list]] = {}
        t0 = clock()
        ns = time.time_ns()
        self.anchor = ((t0 + clock()) / 2, ns)

    def span(self, name: str, **attrs: Any) -> span:
        ctx = span(name, self.metrics, **attrs)
        ctx.tracer = self
        return ctx

    def start(self, name: str, **attrs: Any) -> Span:
        return start(name, **attrs)

    def finish(self, sp: Span) -> Span:
        finish(sp, self.metrics)
        if self.keep and not _stack():       # a root: its tree is whole
            self.kept.append(sp)
        return sp

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to the registry's counter `name` (none without one)."""
        if self.metrics is not None:
            self.metrics.counter(name).inc(n)

    def defer(self, name: str, item: Any,
              reduce: Callable[[list], int]) -> None:
        """Count `item` into `name` later: `reduce` of every pending item
        of `name` is counted at once at the next `snapshot`, or here once
        `DEFER_LIMIT` items wait."""
        items = self.pending.setdefault(name, (reduce, []))[1]
        items.append(item)
        if len(items) >= self.DEFER_LIMIT:
            self._count_pending(name)

    def _count_pending(self, name: str) -> None:
        reduce, items = self.pending.pop(name)
        self.count(name, reduce(items))

    def snapshot(self) -> Dict[str, Any]:
        """The registry's snapshot, every deferred count counted first."""
        for name in list(self.pending):
            self._count_pending(name)
        return self.metrics.snapshot()

    def epoch_ns(self, t: float) -> int:
        """The Unix-epoch nanoseconds of the `clock` time `t`."""
        c, ns = self.anchor
        return ns + round((t - c) * 1e9)


def render_tree(sp: Span, indent: int = 0) -> str:
    """Multi-line ``name  123.4us  k=v`` tree (slow log, REPL, debugging)."""
    attrs = ";".join(f"{k}={v}" for k, v in sp.attrs.items())
    line = f"{'  ' * indent}{sp.name}  {sp.duration_us:.1f}us" + (f"  [{attrs}]" if attrs else "")
    lines = [line]
    for c in sp.children:
        lines.append(render_tree(c, indent + 1))
    return "\n".join(lines)
