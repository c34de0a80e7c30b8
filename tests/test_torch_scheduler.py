"""The port's freshness scheduler (`repro_torch.scheduler`) and the
views-over-views DAG of its catalog, held to the reference's
(`repro.scheduler`, tests/test_scheduler.py) on the CPU.

The reference's own bit-identity contract must hold inside the port: a
lagged 3-view cascade equals an immediate replay of the same stream at
the same commit boundaries, a SUSPEND/RESUME round trip equals never
pausing, and two runs under one modeled clock give the same schedule.
Across the packages, the port's scheduled state equals the reference's
under a modeled clock: the same tick-by-tick `schedule_log`, the same
labels, models, waters, counts and rounds, bit for bit, and the same
SHOW VIEWS / SHOW SCHEDULE rows.

The reference's live-daemon test runs on the wall clock; its counterpart
here drives `tick(now)` with a modeled clock after every commit and
holds staleness to the lag by counts, under the lock witness. The one
real daemon thread is started and stopped with a bounded join, and every
socket read has the client's 30 s limit."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.rdbms as RD                                    # noqa: E402
import repro.scheduler as RS                                # noqa: E402
from repro.data import synthetic_corpus                     # noqa: E402
from repro.rdbms.options import parse_lag as ref_parse_lag  # noqa: E402

import repro_torch.rdbms as TD                              # noqa: E402
import repro_torch.scheduler as TS                          # noqa: E402
from repro_torch.rdbms.options import DOWNSTREAM, parse_lag  # noqa: E402
from repro_torch.scheduler import refresh as fr             # noqa: E402

PORT = (TD, TS)
REF = (RD, RS)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    """Deterministic freshness time: advances only when told."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)
        return self.t


def _catalog(pkg):
    rd = pkg[0]
    return rd.Catalog(device="cpu") if rd is TD else rd.Catalog()


def _cascade(pkg=PORT, seed=7, *, lags=("2 s", "downstream", None),
             group=8, n=240, d=12):
    """table t -> root view a -> derived b -> derived c, with the given
    target lags (None = immediate), on a modeled freshness clock."""
    c = synthetic_corpus("sched", n, d, seed=seed)
    catalog = _catalog(pkg)
    clock = FakeClock()
    catalog.clock = clock
    catalog.register_table("t", c.features, truth=c.labels)
    opts = {"policy": "eager", "cost_mode": "modeled"}
    for name, parent, lag in (("a", "t", lags[0]), ("b", "a", lags[1]),
                              ("c", "b", lags[2])):
        o = dict(opts)
        if lag is not None:
            o["target_lag"] = lag
        catalog.create_view(name, parent, "svm", o)
    ex = pkg[0].Executor(catalog, group_commit=group)
    return c, catalog, clock, ex


def _stream(ex, corpus, count, *, start=0):
    for j in range(start, start + count):
        i = j % corpus.features.shape[0]
        ex.execute_one(f"INSERT INTO t (id, label) VALUES "
                       f"({i}, {int(corpus.labels[i])})")


def _state(catalog, name):
    """Bit-comparable state of one view: labels, model, waters, counts,
    rounds."""
    vd = catalog.view(name)
    v = vd.facade.view
    n = v.F.shape[0]
    return (np.array([vd.facade.label(i) for i in range(n)], np.int8),
            v.model.w.copy(), float(v.model.b),
            tuple(float(x) for w in vd.facade.waters() for x in w),
            vd.facade.counts().copy(), v.engine.stats.rounds)


def _assert_same_state(catalog_a, catalog_b, names=("a", "b", "c")):
    for name in names:
        sa, sb = _state(catalog_a, name), _state(catalog_b, name)
        np.testing.assert_array_equal(sa[0], sb[0], err_msg=f"{name} labels")
        np.testing.assert_array_equal(sa[1], sb[1], err_msg=f"{name} w")
        assert sa[2] == sb[2], f"{name} bias"
        assert sa[3] == sb[3], f"{name} waters"
        np.testing.assert_array_equal(sa[4], sb[4], err_msg=f"{name} counts")
        assert sa[5] == sb[5], f"{name} rounds"


def _same_rows(ex_ref, ex_port, sql):
    r, t = ex_ref.execute_one(sql), ex_port.execute_one(sql)
    assert t.columns == r.columns and t.rows == r.rows, sql
    return t


# ---------------------------------------------------------------------------
# DDL surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text,want", [("5 s", 5.0), ("500 ms", 0.5),
                                       ("2 m", 120.0), (3, 3.0),
                                       ("1.5 s", 1.5), (None, None)])
def test_parse_lag_units(text, want):
    assert parse_lag(text) == ref_parse_lag(text) == want


@pytest.mark.parametrize("bad", ["fortnight", "-2 s", 0, "5 parsecs"])
def test_parse_lag_errors_equal_reference(bad):
    with pytest.raises(RD.PlanError) as er:
        ref_parse_lag(bad)
    with pytest.raises(TD.PlanError) as et:
        parse_lag(bad)
    assert str(et.value) == str(er.value)


def test_parse_lag_downstream():
    assert parse_lag("downstream") is DOWNSTREAM


def test_create_derived_view_registers_dag_edge():
    _c, catalog, _clock, _ex = _cascade()
    b = catalog.view("b")
    assert b.source == "a" and b.table == "t"
    assert [v.name for v in catalog.parents_of("b")] == ["a"]
    assert [v.name for v in catalog.children_of("a")] == ["b"]
    assert [v.name for v in catalog.topo_order()] == ["a", "b", "c"]
    assert b.facade.d == 1
    assert not b.facade.supports_delete
    assert type(b.facade).__name__ == "DerivedViewFacade"
    assert b.facade.view.engine.device.type == "cpu"


def test_cycle_rejected_at_create():
    c = synthetic_corpus("cyc", 64, 8, seed=3)
    catalog = TD.Catalog(device="cpu")
    catalog.register_table("t", c.features, truth=c.labels)
    with pytest.raises(TD.PlanError, match="cycle"):
        catalog.create_view("self", "self", "svm", {})
    catalog.create_view("root", "t", "svm", {"cost_mode": "modeled"})
    ex = TD.Executor(catalog)
    with pytest.raises(TD.PlanError, match="cycle"):
        ex.execute_one("CREATE CLASSIFICATION VIEW loop ON loop "
                       "USING MODEL svm")
    catalog.create_view("kid", "root", "svm", {"cost_mode": "modeled"})
    assert [v.name for v in catalog.topo_order()] == ["root", "kid"]


@pytest.mark.parametrize("name,opts", [("d1", {"k": 3}),
                                       ("d2", {"engine": "sharded"}),
                                       ("d3", {"memory_budget": 0.5}),
                                       ("d4", {"prefetch": True})])
def test_derived_view_restrictions_equal_reference(name, opts):
    _c, port, _clock, _ex = _cascade()
    _c, ref, _clock, _ex = _cascade(REF)
    with pytest.raises(RD.PlanError) as er:
        ref.create_view(name, "a", "svm", opts)
    with pytest.raises(TD.PlanError) as et:
        port.create_view(name, "a", "svm", opts)
    assert str(et.value) == str(er.value)


def test_alter_set_is_schema_checked():
    _c, catalog, _clock, ex = _cascade()
    ex.execute_one("ALTER VIEW c SET (target_lag = '3 s')")
    assert catalog.view("c").options.target_lag == 3.0
    with pytest.raises(TD.PlanError, match="alterable"):
        ex.execute_one("ALTER VIEW c SET (policy = lazy)")
    with pytest.raises(TD.PlanError, match="valid view option"):
        ex.execute_one("ALTER VIEW c SET (bogus = 1)")
    with pytest.raises(TD.PlanError):
        ex.execute_one("ALTER VIEW c SET (target_lag = 'soon')")


def test_downstream_lag_propagation():
    _c, catalog, _clock, ex = _cascade(lags=("downstream", "downstream",
                                             "2 s"))
    assert catalog.effective_lag("c") == 2.0
    assert catalog.effective_lag("b") == 2.0
    assert catalog.effective_lag("a") == 2.0
    ex.execute_one("ALTER VIEW c SET (target_lag = '500 ms')")
    assert catalog.effective_lag("a") == 0.5
    _c2, catalog2, _cl2, _ex2 = _cascade(lags=("downstream", "downstream",
                                               None))
    assert catalog2.effective_lag("a") is None
    assert not fr.is_scheduled(catalog2, catalog2.view("a"))


# ---------------------------------------------------------------------------
# lagged == immediate, inside the port and across the packages
# ---------------------------------------------------------------------------

def _lagged_run(pkg):
    c, lagged, clock, ex_l = _cascade(pkg, lags=("2 s", "downstream",
                                                 "500 ms"))
    sched = pkg[1].FreshnessScheduler(ex_l, clock=clock)
    for round_no in range(6):
        _stream(ex_l, c, 24, start=24 * round_no)
        clock.advance(0.4)
        sched.tick()
    return c, lagged, ex_l, sched


def test_lagged_cascade_bit_identical_to_immediate_replay():
    c, lagged, ex_l, _sched = _lagged_run(PORT)
    _c2, immediate, _clk, ex_i = _cascade(lags=(None, None, None))
    _stream(ex_i, c, 144)
    ex_l.execute_one("COMMIT")
    ex_i.execute_one("COMMIT")
    ex_l.refresh_views()
    ex_i.refresh_views()
    _assert_same_state(lagged, immediate)


def test_lagged_cascade_equals_reference_tick_by_tick():
    """The port's scheduler makes the reference's decisions: the same
    `schedule_log`, the same SHOW SCHEDULE rows before the barrier, the
    same state after it."""
    _c, port, ex_t, sched_t = _lagged_run(PORT)
    _c, ref, ex_r, sched_r = _lagged_run(REF)
    assert sched_t.schedule_log == sched_r.schedule_log
    assert any(names for _, names in sched_t.schedule_log)
    _same_rows(ex_r, ex_t, "SHOW SCHEDULE")
    _same_rows(ex_r, ex_t, "SHOW VIEWS")
    _assert_same_state(ref, port)
    for ex in (ex_t, ex_r):
        ex.execute_one("COMMIT")
    assert ex_t.refresh_views() == ex_r.refresh_views()
    _assert_same_state(ref, port)
    _same_rows(ex_r, ex_t, "SHOW SCHEDULE")


def _deterministic_run(pkg):
    c, catalog, clock, ex = _cascade(pkg, lags=("2 s", "downstream", "1 s"))
    sched = pkg[1].FreshnessScheduler(ex, clock=clock)
    rng = np.random.default_rng(11)
    for step in range(40):
        _stream(ex, c, int(rng.integers(1, 7)), start=step * 7)
        clock.advance(float(rng.uniform(0.05, 0.6)))
        sched.tick()
    ex.execute_one("COMMIT")
    ex.refresh_views()
    return sched.schedule_log, catalog


def test_scheduler_is_deterministic_under_modeled_clock():
    log1, cat1 = _deterministic_run(PORT)
    log2, cat2 = _deterministic_run(PORT)
    assert log1 == log2
    assert any(names for _, names in log1)
    _assert_same_state(cat1, cat2)
    log_ref, cat_ref = _deterministic_run(REF)
    assert log1 == log_ref
    _assert_same_state(cat1, cat_ref)


def test_refresh_runs_in_topological_order():
    c, catalog, clock, ex = _cascade(lags=("2 s", "2 s", "2 s"))
    _stream(ex, c, 16)
    ex.execute_one("COMMIT")
    clock.advance(5.0)
    names = ex.refresh_views()
    order = {n: i for i, n in enumerate(names)}
    assert order["a"] < order["b"] < order["c"]
    _stream(ex, c, 16, start=16)
    ex.execute_one("COMMIT")
    clock.advance(5.0)
    assert ex.refresh_views("c") == ["a", "b", "c"]


def _suspend_run(pkg):
    c, suspended, clock, ex_s = _cascade(pkg, lags=("2 s", None, None))
    _stream(ex_s, c, 24)
    ex_s.execute_one("COMMIT")
    ex_s.refresh_views()
    ex_s.execute_one("ALTER VIEW a SUSPEND")
    frozen = _state(suspended, "a")
    _stream(ex_s, c, 40, start=24)
    ex_s.execute_one("COMMIT")
    assert "a" not in ex_s.refresh_views()
    after = _state(suspended, "a")
    np.testing.assert_array_equal(frozen[0], after[0])
    assert frozen[5] == after[5]
    rt = suspended.view("a").runtime
    clock.advance(3.0)
    assert rt.inbox_rows() == 40 and rt.staleness(clock()) > 0
    resumed = ex_s.execute_one("ALTER VIEW a RESUME")
    assert suspended.view("a").runtime.inbox_rows() == 0
    ex_s.refresh_views()
    return c, suspended, ex_s, resumed


def test_suspend_freezes_resume_catches_up_exactly_once():
    c, suspended, ex_s, _res = _suspend_run(PORT)
    _c2, straight, _clk, ex_n = _cascade(lags=("2 s", None, None))
    _stream(ex_n, c, 64)
    ex_n.execute_one("COMMIT")
    ex_n.refresh_views()
    # the straight run commits its 64 rows at other boundaries (8 groups
    # of 8 either way: 24 and 40 are multiples of the group size)
    _assert_same_state(suspended, straight)
    rounds = _state(suspended, "a")[5]
    ex_s.execute_one("ALTER VIEW a RESUME")
    assert _state(suspended, "a")[5] == rounds


def test_suspend_resume_equals_reference():
    _c, port, ex_t, res_t = _suspend_run(PORT)
    _c, ref, ex_r, res_r = _suspend_run(REF)
    assert res_t.columns == res_r.columns and res_t.rows == res_r.rows
    _assert_same_state(ref, port)
    _same_rows(ex_r, ex_t, "SHOW VIEWS")


def test_suspended_ancestor_blocks_descendants():
    c, catalog, clock, ex = _cascade(lags=("2 s", "2 s", "2 s"))
    ex.execute_one("ALTER VIEW b SUSPEND")
    _stream(ex, c, 16)
    ex.execute_one("COMMIT")
    clock.advance(10.0)
    names = ex.refresh_views()
    assert "a" in names and "b" not in names
    assert catalog.view("c").runtime.stale_since is not None
    assert fr.upstream_blocked(catalog, catalog.view("c"))
    sched = TS.FreshnessScheduler(ex, clock=clock)
    assert catalog.view("c") not in sched.due(clock())
    ex.execute_one("ALTER VIEW b RESUME")
    ex.refresh_views()
    assert catalog.view("c").runtime.stale_since is None


def test_delete_rejected_on_scheduled_or_derived_views():
    c, _catalog, _clock, ex = _cascade(lags=("2 s", None, None))
    _stream(ex, c, 8)
    with pytest.raises(Exception, match="cannot"):
        ex.execute_one("DELETE FROM t WHERE id = 3")
    catalog = TD.Catalog(device="cpu")
    catalog.register_table("t", c.features, truth=c.labels)
    catalog.create_view("solo", "t", "svm",
                        {"cost_mode": "modeled", "target_lag": "2 s"})
    ex2 = TD.Executor(catalog, group_commit=4)
    _stream(ex2, c, 4)
    with pytest.raises(Exception, match="immediate"):
        ex2.execute_one("DELETE FROM t WHERE id = 3")
        ex2.execute_one("COMMIT")


def test_show_views_and_schedule_surfaces_equal_reference():
    c, port, clock_t, ex_t = _cascade(lags=("2 s", "downstream", None))
    _c, ref, clock_r, ex_r = _cascade(REF, lags=("2 s", "downstream", None))
    rows = {r[0]: r for r in _same_rows(ex_r, ex_t, "SHOW VIEWS").rows}
    assert rows["a"][4] == "scheduled" and rows["c"][4] == "immediate"
    assert rows["b"][5] == "downstream" and rows["b"][6] == "-"
    for ex in (ex_t, ex_r):
        _stream(ex, c, 8)
        ex.execute_one("COMMIT")
    clock_t.advance(1.0)
    clock_r.advance(1.0)
    res = _same_rows(ex_r, ex_t, "SHOW SCHEDULE")
    a = dict(zip(res.columns, {r[0]: r for r in res.rows}["a"]))
    assert a["staleness_s"] == pytest.approx(1.0) and a["inbox_rows"] == 8
    assert a["priority"] != "-"
    _same_rows(ex_r, ex_t, "ALTER VIEW a SUSPEND")
    rows = {r[0]: r for r in _same_rows(ex_r, ex_t, "SHOW VIEWS").rows}
    assert rows["a"][4] == "suspended"
    snap = ex_t.metrics_snapshot()
    assert {r["view"] for r in snap["schedule"]} == {"a", "b", "c"}
    assert snap["schedule"] == ex_r.metrics_snapshot()["schedule"]


# ---------------------------------------------------------------------------
# the daemon: ticks on a modeled clock, one bounded real thread
# ---------------------------------------------------------------------------

def test_ticks_keep_staleness_under_lag_by_counts():
    """Counterpart of the reference's live-daemon test, on a modeled
    clock: a tick after every commit (12 ms of modeled time apart) keeps
    every scheduled view's staleness at or under its effective lag, the
    refresher takes gate < wal_commit < pool in the witness's order (a
    memory-budgeted root view), and the registry counts the refreshes."""
    from repro_torch.analysis import witness

    with witness.enabled():
        c = synthetic_corpus("live", 240, 12, seed=5)
        catalog = TD.Catalog(device="cpu")
        clock = FakeClock()
        catalog.clock = clock
        catalog.register_table("t", c.features, truth=c.labels)
        catalog.create_view("a", "t", "svm",
                            {"policy": "eager", "cost_mode": "modeled",
                             "memory_budget": 0.5, "target_lag": "2 s"})
        catalog.create_view("b", "a", "svm",
                            {"cost_mode": "modeled",
                             "target_lag": "downstream"})
        ex = TD.Executor(catalog, group_commit=8)
        sched = TS.FreshnessScheduler(ex, clock=clock)
        try:
            peak = 0.0
            for j in range(240):
                i = j % 240
                ex.execute_one(f"INSERT INTO t (id, label) VALUES "
                               f"({i}, {int(c.labels[i])})")
                clock.advance(0.012)
                sched.tick()
                now = catalog.clock()
                for vd in catalog.topo_order():
                    if catalog.effective_lag(vd.name) is not None:
                        peak = max(peak, vd.runtime.staleness(now))
            assert 0.0 < peak <= 2.0, peak
            refreshes = ex.metrics.counter("scheduler.refreshes").value
            assert refreshes == sum(len(names)
                                    for _, names in sched.schedule_log) > 0
            assert ex.metrics.counter("scheduler.ticks").value == 240
            ex.refresh_views()
            assert catalog.view("a").runtime.inbox == []
            assert catalog.view("a").facade.view.engine.check_consistent()
        finally:
            close_catalog(catalog)


def test_daemon_thread_starts_refreshes_and_stops():
    """The real thread: started, it drains a lagged view's inbox (waited
    for with a limit), and `stop()` joins it with its bounded join."""
    c = synthetic_corpus("live", 240, 12, seed=5)
    catalog = TD.Catalog(device="cpu")
    clock = FakeClock()
    catalog.clock = clock
    catalog.register_table("t", c.features, truth=c.labels)
    catalog.create_view("a", "t", "svm",
                        {"cost_mode": "modeled", "target_lag": "1 s"})
    ex = TD.Executor(catalog, group_commit=8)
    _stream(ex, c, 16)
    assert catalog.view("a").runtime.inbox_rows() == 16
    clock.advance(5.0)                # past the lag: due at the next tick
    sched = TS.FreshnessScheduler(ex, interval=0.005).start()
    try:
        done = threading.Event()

        def drained():
            while not done.wait(0.005):
                if not catalog.view("a").runtime.inbox:
                    return
        waiter = threading.Thread(target=drained, daemon=True)
        waiter.start()
        waiter.join(30)
        done.set()
        assert not waiter.is_alive()
        assert catalog.view("a").runtime.inbox_rows() == 0
    finally:
        sched.stop()
    assert sched._thread is None
    assert ex.metrics.counter("scheduler.refreshes").value >= 1


def test_refresh_records_cost_beside_the_modeled_charge():
    c, catalog, clock, ex = _cascade(lags=("2 s", None, None))
    _stream(ex, c, 16)
    ex.refresh_views()
    snap = catalog.view("a").runtime.cost.snapshot(0)
    assert snap["steps_measured"] == 1
    assert snap["charge_modeled"] > 0 and snap["seconds_measured"] > 0


def close_catalog(catalog):
    """Close every prefetcher, pool and entity store of a catalog (a
    budgeted view's store is a temp file until then)."""
    for vd in catalog.views.values():
        pool = getattr(getattr(vd.facade, "engine", None), "store", None)
        if pool is not None:
            if getattr(pool, "prefetcher", None) is not None:
                pool.prefetcher.close()
            pool.close()
    for t in catalog.tables.values():
        for es in t.stores.values():
            es.close()


# ---------------------------------------------------------------------------
# the wire: refresh barrier, typed client, legacy wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client_pkg", [RD, TD], ids=["ref-client",
                                                      "port-client"])
def test_wire_refresh_barrier_and_typed_client(client_pkg):
    """The port's server behind the reference's client and its own."""
    c = synthetic_corpus("wire", 200, 10, seed=9)
    catalog = TD.Catalog(device="cpu")
    catalog.register_table("t", c.features, truth=c.labels)
    ex = TD.Executor(catalog, group_commit=4)
    handle = TD.start_server_thread(ex)
    try:
        with client_pkg.SqlClient.connect(*handle.address) as cl:
            cl.run("CREATE CLASSIFICATION VIEW a ON t USING MODEL svm "
                   "WITH (cost_mode = modeled, target_lag = '60 s');"
                   "CREATE CLASSIFICATION VIEW b ON a USING MODEL svm "
                   "WITH (cost_mode = modeled, target_lag = 'downstream')")
            for j in range(12):
                cl.run(f"INSERT INTO t (id, label) VALUES "
                       f"({j}, {int(c.labels[j])})")
            rows = {r.view: r for r in cl.show("schedule")}
            assert rows["a"].inbox_rows == 12
            assert cl.refresh() == ["a", "b"]
            rows = {r.view: r for r in cl.show("schedule")}
            assert rows["a"].inbox_rows == 0 and rows["a"].staleness_s == 0.0
            cl.suspend("a")
            assert {r.view: r.state for r in cl.show("views")}["a"] \
                == "suspended"
            cl.resume("a")
            cl.alter_view("a", target_lag="downstream")
            cl.alter_view("b", target_lag="1 s")
            rows = {r.view: r for r in cl.show("views")}
            assert rows["a"].target_lag == "downstream"
            assert rows["a"].effective_lag == "1 s"
            with pytest.deprecated_call():
                legacy = cl.query_one("SHOW SCHEDULE")
            assert legacy.rows == cl.run_one("SHOW SCHEDULE").rows
    finally:
        handle.stop()


def test_legacy_client_wrappers_pin_wire_format():
    """The port's client sends the reference client's request frames for
    every call, new and legacy spellings alike."""
    sent = {"ref": [], "port": []}

    def probe(pkg, key):
        class Probe(pkg.SqlClient):
            def __init__(self):
                super().__init__(sock=None)

            def request(self, obj):
                sent[key].append(obj)
                return {"ok": True, "refreshed": [],
                        "results": [{"columns": [], "rows": []}]}
        return Probe()

    for pkg, key in ((RD, "ref"), (TD, "port")):
        p = probe(pkg, key)
        p.run("SHOW TABLES")
        with pytest.deprecated_call():
            p.query("SHOW TABLES")
        p.run_prepared("pt", [1, 2])
        with pytest.deprecated_call():
            p.execute("pt", [1, 2])
        p.alter_view("a", target_lag="5 s", prefetch=True)
        p.suspend("a")
        p.refresh("a")
        p.show("cost", view="a")
    assert sent["port"] == sent["ref"]
    assert sent["port"][0] == sent["port"][1] == {"op": "query",
                                                  "sql": "SHOW TABLES"}
    from repro.rdbms import wire as RW
    from repro_torch.rdbms import wire as TW
    for obj in sent["port"]:
        assert TW.encode_frame(obj) == RW.encode_frame(obj)
