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
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

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


@contextmanager
def span(name: str, metrics: Any = None, **attrs: Any) -> Iterator[Span]:
    sp = start(name, **attrs)
    try:
        yield sp
    finally:
        finish(sp, metrics)


class Tracer:
    """A span factory bound to one metrics registry."""

    def __init__(self, metrics: Any = None) -> None:
        self.metrics = metrics

    def span(self, name: str, **attrs: Any):
        return span(name, metrics=self.metrics, **attrs)

    def start(self, name: str, **attrs: Any) -> Span:
        return start(name, **attrs)

    def finish(self, sp: Span) -> Span:
        return finish(sp, self.metrics)


def render_tree(sp: Span, indent: int = 0) -> str:
    """Multi-line ``name  123.4us  k=v`` tree (slow log, REPL, debugging)."""
    attrs = ";".join(f"{k}={v}" for k, v in sp.attrs.items())
    line = f"{'  ' * indent}{sp.name}  {sp.duration_us:.1f}us" + (f"  [{attrs}]" if attrs else "")
    lines = [line]
    for c in sp.children:
        lines.append(render_tree(c, indent + 1))
    return "\n".join(lines)
