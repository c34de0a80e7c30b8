"""The port's telemetry (`repro_torch.obs`) against the reference's
(`repro.obs`): the cases of tests/test_obs.py that need only the obs
package — counters and gauges, histogram bucket routing and the
bucket-edge quantile rule, the registry (get-or-create, snapshots, dead
collectors, an 8-thread hammer), spans (nesting, unwinding through
orphans, recording into a registry), `render_tree`, the cost recorder and
the overhead guard — each run on both packages with the same inputs.

Everything is stdlib, so the comparison is exact: equal bucket edges,
equal counts, sums and quantiles, equal snapshots and equal
`render_tree` text (span durations, which come from the clock, are
pinned before rendering). The one tolerance is the reference test's own:
`pytest.approx` on float sums."""
import threading

import pytest

pytest.importorskip("torch")

import repro.obs as R                                       # noqa: E402
from repro.obs import trace as RT                           # noqa: E402

import repro_torch.obs as T                                 # noqa: E402
from repro_torch.obs import trace as TT                     # noqa: E402

BOTH = pytest.mark.parametrize("obs", [R, T], ids=["reference", "port"])


def test_same_names_and_bucket_edges():
    assert T.__all__ == R.__all__
    assert T.DEFAULT_TIME_BUCKETS == R.DEFAULT_TIME_BUCKETS
    assert T.DEFAULT_COUNT_BUCKETS == R.DEFAULT_COUNT_BUCKETS
    assert T.clock is R.clock          # both are time.perf_counter


@BOTH
def test_counter_gauge_basics(obs):
    c, g = obs.Counter(), obs.Gauge()
    c.inc()
    c.inc(41)
    g.set(2.5)
    assert c.value == 42 and g.value == 2.5


def _routed(obs):
    h = obs.Histogram(bounds=(1.0, 2.0, 4.0, 8.0))
    for x in (0.5, 1.0, 1.5, 3.0, 3.0, 7.9, 100.0):
        h.observe(x)
    return h


@BOTH
def test_histogram_bucket_routing_and_quantiles(obs):
    h = _routed(obs)
    assert h.counts == [2, 1, 2, 1, 1]
    assert h.count == 7 and h.sum == pytest.approx(116.9)
    assert h.quantile(0.5) == 4.0
    assert h.quantile(0.99) == float("inf")
    assert h.mean == pytest.approx(116.9 / 7)
    snap = h.snapshot()
    assert snap["count"] == 7 and snap["p50"] == 4.0
    assert snap["p99"] == float("inf") and snap["counts"] == h.counts


def test_histogram_snapshots_equal():
    assert _routed(T).snapshot() == _routed(R).snapshot()
    a, b = T.Histogram(), R.Histogram()
    for x in (3e-7, 1e-6, 4e-6, 0.02, 0.02, 7.0, 11.0):
        a.observe(x)
        b.observe(x)
    assert a.snapshot() == b.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert a.quantile(q) == b.quantile(q)


@BOTH
def test_histogram_quantile_exact_on_bucket_edges(obs):
    h = obs.Histogram(bounds=(1, 2, 3, 4, 5, 6, 7, 8, 9, 10))
    for x in range(1, 101):
        h.observe((x - 1) % 10 + 1)
    assert h.quantile(0.50) == 5
    assert h.quantile(0.99) == 10
    assert h.quantile(0.10) == 1


@BOTH
def test_empty_histogram(obs):
    h = obs.Histogram()
    assert h.quantile(0.5) == 0.0 and h.mean == 0.0
    assert h.snapshot()["p99"] == 0.0


def _registry(obs):
    reg = obs.MetricsRegistry()
    assert reg.counter("a") is reg.counter("a")
    assert reg.histogram("h") is reg.histogram("h")
    reg.counter("a").inc(3)
    reg.gauge("g").set(7)
    reg.histogram("h").observe(0.003)
    reg.register_collector("comp", lambda: {"x": 1})
    return reg


@BOTH
def test_registry_get_or_create_and_snapshot(obs):
    snap = _registry(obs).snapshot()
    assert snap["counters"]["a"] == 3 and snap["gauges"]["g"] == 7
    assert snap["comp"] == {"x": 1}


def test_registry_snapshots_equal():
    assert _registry(T).snapshot() == _registry(R).snapshot()


@BOTH
def test_registry_collector_errors_are_contained(obs):
    reg = obs.MetricsRegistry()

    def boom():
        raise RuntimeError("dead component")

    reg.register_collector("bad", boom)
    assert reg.snapshot()["bad"] == {"error": "RuntimeError"}


@BOTH
def test_registry_hammer_reconciles_exactly(obs):
    reg = obs.MetricsRegistry()
    threads_n, ops = 8, 5000

    def work():
        c = reg.counter("hits")
        h = reg.histogram("lat", buckets=(1, 2, 4))
        for i in range(ops):
            c.inc()
            reg.counter("hits")
            h.observe(1 + (i % 3))

    ts = [threading.Thread(target=work) for _ in range(threads_n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    h = reg.histogram("lat")
    assert reg.counter("hits").value == threads_n * ops
    assert h.count == threads_n * ops
    expected = [0, 0, 0, 0]
    for i in range(ops):
        expected[i % 3] += threads_n
    assert h.counts == expected
    assert h.sum == pytest.approx(threads_n * sum(1 + (i % 3)
                                                  for i in range(ops)))


@BOTH
def test_span_nesting_and_parenting(obs):
    tr = obs.trace
    with tr.span("root") as root:
        with tr.span("child", k=1) as c1:
            assert tr.current() is c1
            with tr.span("grand"):
                pass
        with tr.span("child"):
            pass
    assert tr.current() is None
    assert [c.name for c in root.children] == ["child", "child"]
    assert [g.name for g in root.children[0].children] == ["grand"]
    assert root.t1 is not None and root.duration_s >= 0
    assert root.find("grand") is not None
    assert root.sum_us("child") >= root.children[0].children[0].duration_us


@BOTH
def test_span_finish_unwinds_through_exceptions(obs):
    tr = obs.trace
    root = tr.start("root")
    tr.start("orphan1")
    tr.start("orphan2")
    tr.finish(root)
    assert tr.current() is None
    sp = tr.start("fresh")
    tr.finish(sp)
    assert root.children[0].name == "orphan1"


@BOTH
def test_span_records_into_registry(obs):
    reg = obs.MetricsRegistry()
    with obs.trace.span("phase", metrics=reg):
        pass
    assert reg.histogram("span.phase.seconds").count == 1
    tracer = obs.Tracer(reg)
    with tracer.span("phase"):
        pass
    tracer.finish(tracer.start("other"))
    assert reg.histogram("span.phase.seconds").count == 2
    assert reg.histogram("span.other.seconds").count == 1


def _pinned_tree(tr):
    """A span tree with attributes, its clock stamps pinned."""
    with tr.span("a", kind="x", n=3) as a:
        with tr.span("b"):
            with tr.span("c", hit=True):
                pass
        with tr.span("d"):
            pass
    for i, s in enumerate(a.walk()):
        s.t0, s.t1 = 1.0 + i, 1.0 + i + 0.25e-3 * (i + 1)
    return a


@BOTH
def test_render_tree_shape(obs):
    text = obs.render_tree(_pinned_tree(obs.trace))
    lines = text.splitlines()
    assert lines[0].startswith("a ") and "[kind=x;n=3]" in lines[0]
    assert lines[1].startswith("  b ")
    assert lines[2].startswith("    c ")


def test_render_tree_text_and_dicts_equal():
    t, r = _pinned_tree(TT), _pinned_tree(RT)
    assert TT.render_tree(t) == RT.render_tree(r)
    assert t.to_dict() == r.to_dict()


def _costs(obs):
    rec = obs.ViewCostRecorder(2)
    rec.record_reorg(0, 0.5)
    rec.record_reorg(0, 1.5)
    rec.record_step(0, 0.25, 2.0)
    rec.record_step(0, 0.75, 2.0)
    return rec


@BOTH
def test_cost_recorder_snapshot(obs):
    rec = _costs(obs)
    s = rec.snapshot(0)
    assert s["reorgs_measured"] == 2
    assert s["S_measured_mean_s"] == pytest.approx(1.0)
    assert s["steps_measured"] == 2
    assert s["charge_modeled"] == pytest.approx(4.0)
    assert s["seconds_measured"] == pytest.approx(1.0)
    assert s["seconds_per_charge"] == pytest.approx(0.25)
    empty = rec.snapshot(1)
    assert empty["steps_measured"] == 0
    assert empty["seconds_per_charge"] is None


def test_cost_recorder_snapshots_equal():
    t, r = _costs(T), _costs(R)
    assert [t.snapshot(v) for v in (0, 1)] == [r.snapshot(v) for v in (0, 1)]


@BOTH
def test_telemetry_overhead_is_bounded(obs):
    reg = obs.MetricsRegistry()
    c = reg.counter("x")
    h = reg.histogram("y")
    t0 = obs.clock()
    for _ in range(10000):
        c.inc()
        h.observe(1e-4)
    per_op = (obs.clock() - t0) / 10000
    assert per_op < 50e-6
