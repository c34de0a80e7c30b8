"""The port's concurrent SQL surface (`repro_torch.rdbms`: wire, epoch
gate, sessions, the asyncio server, the telemetry surfaces of the
executor) held to the reference's (tests/test_serve.py and the executor
and wire cases of tests/test_obs.py), on the CPU.

What must hold: wire frames byte for byte the reference's (the port's
encoder against the reference's, a reference `SqlClient` against the
port's server, decoding the same values); the gate's scheduling
contracts; read-your-writes and private prepared statements per session;
and the acceptance shape of tests/test_serve.py: a swarm of concurrent
sessions (point reads under the shared gate, so several threads are
inside the port's probe paths at once) leaves the engines equal to the
same WAL replayed serially, and equal to the reference executor fed that
WAL. The telemetry cases run on the port's executor; the reference's
wall-clock overhead guard is replaced by counts (every statement feeds
each of its instruments exactly once). Every thread join has a limit and
every client socket read the client's 30 s timeout."""
import io
import logging
import socket
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.rdbms as RD                                    # noqa: E402
from repro.data import multiclass_corpus                    # noqa: E402
from repro.rdbms import wire as RW                          # noqa: E402

import repro_torch.rdbms as TD                              # noqa: E402
from repro_torch.core.facade import TIERS                   # noqa: E402
from repro_torch.rdbms import wire as TW                    # noqa: E402
from repro_torch.rdbms.ast_nodes import SqlError            # noqa: E402
from repro_torch.rdbms.wire import (MAX_FRAME, WireError,   # noqa: E402
                                    decode_payload, encode_frame,
                                    frame_length)

JOIN_S = 60


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CORPUS = multiclass_corpus("serve_t", 300, 16, 4, seed=11)


def _executor(group_commit=64, pkg=TD):
    catalog = pkg.Catalog(device="cpu") if pkg is TD else pkg.Catalog()
    catalog.register_table("t", _CORPUS.features, truth=_CORPUS.classes,
                           num_classes=_CORPUS.num_classes)
    catalog.create_view("v", "t", "svm",
                        {"k": _CORPUS.num_classes, "policy": "hybrid",
                         "cost_mode": "modeled"})
    return pkg.Executor(catalog, group_commit=group_commit)


def _obs_executor(policy="hybrid", **view_opts):
    """tests/test_obs.py's executor, on the port."""
    ex = TD.Executor(group_commit=4, device="cpu")
    ex.execute_one("CREATE TABLE t FROM CORPUS synthetic WITH (scale = 0.05)")
    opts = {"policy": policy, "cost_mode": "modeled", **view_opts}
    with_clause = ", ".join(f"{k} = {v}" for k, v in opts.items())
    ex.execute_one(f"CREATE CLASSIFICATION VIEW v ON t USING MODEL svm "
                   f"WITH ({with_clause})")
    for i in range(8):
        ex.execute_one(f"INSERT INTO t VALUES ({i}, {1 if i % 2 else -1})")
    return ex


def _join_all(threads):
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("obj", [
    {"op": "query", "rows": [[np.int64(3), np.float32(0.5)]],
     "arr": np.arange(3)},
    {"ok": True, "results": [{"columns": ["id", "margin"],
                              "rows": [[1, np.float64(-0.125)]],
                              "epoch": 4, "tiers": ["water", "disk"]}],
     "session": 2, "elapsed_us": 12.5},
    {"ok": False, "error": "unknown view 'x'", "error_type": "PlanError"},
    {"op": "execute", "name": "pt", "params": [1, 2.5, -1]},
    {"label": np.int8(-1), "count": np.int64(2 ** 40), "u": "é",
     "m": np.float32(1e-7), "nan": float("inf")},
])
def test_wire_frames_equal_reference(obj):
    frame = encode_frame(obj)
    assert frame == RW.encode_frame(obj)
    assert frame_length(frame[:4]) == len(frame) - 4
    assert decode_payload(frame[4:]) == RW.decode_payload(frame[4:])


def test_wire_roundtrip_coerces_numpy_scalars():
    obj = {"op": "query", "rows": [[np.int64(3), np.float32(0.5)]],
           "arr": np.arange(3)}
    back = decode_payload(encode_frame(obj)[4:])
    assert back["rows"] == [[3, 0.5]] and back["arr"] == [0, 1, 2]


def test_wire_rejects_oversized_and_desynced_frames():
    with pytest.raises(WireError):
        frame_length((MAX_FRAME + 1).to_bytes(4, "big"))
    with pytest.raises(TypeError):
        encode_frame({"bad": object()})
    with pytest.raises(TypeError):                # a torch value never passes
        encode_frame({"bad": torch.tensor(1)})
    assert MAX_FRAME == RW.MAX_FRAME


# ---------------------------------------------------------------------------
# epoch gate
# ---------------------------------------------------------------------------

def test_gate_writer_waits_for_pinned_readers():
    gate = TD.EpochGate()
    entered = threading.Event()
    done = []

    def writer():
        with gate.write():
            entered.set()
            done.append(True)

    with gate.read():
        t = threading.Thread(target=writer, daemon=True)
        t.start()
        assert not entered.wait(0.15)
        assert not done
    t.join(5)
    assert done


def test_gate_waiting_writer_blocks_new_readers():
    gate = TD.EpochGate()
    writer_in, reader_in = threading.Event(), threading.Event()
    release, late = threading.Event(), threading.Event()

    def slow_reader():
        with gate.read():
            reader_in.set()
            release.wait(5)

    def writer():
        with gate.write():
            writer_in.set()

    def late_reader():
        with gate.read():
            late.set()

    r = threading.Thread(target=slow_reader, daemon=True)
    r.start()
    assert reader_in.wait(5)
    w = threading.Thread(target=writer, daemon=True)
    w.start()
    time.sleep(0.05)
    lr = threading.Thread(target=late_reader, daemon=True)
    lr.start()
    assert not late.wait(0.15)
    release.set()
    assert writer_in.wait(5) and late.wait(5)
    _join_all((r, w, lr))


def test_reader_pinned_epoch_cannot_advance_midstatement():
    ex = _executor(group_commit=4)
    committed = threading.Event()

    def writer():
        for i in range(4):
            ex.execute_one(f"INSERT INTO t (id, class) VALUES "
                           f"({i}, {int(_CORPUS.classes[i])})")
        committed.set()

    with ex.gate.read():
        epoch0 = ex.log.commits
        t = threading.Thread(target=writer, daemon=True)
        t.start()
        assert not committed.wait(0.2)
        assert ex.log.commits == epoch0
    t.join(5)
    assert committed.is_set() and ex.log.commits == epoch0 + 1


def test_gate_lock_is_witnessed_as_gate():
    from repro_torch.analysis import witness
    with witness.enabled():
        ex = _executor(group_commit=2)
        for j in range(4):
            ex.execute_one(f"INSERT INTO t (id, class) VALUES "
                           f"({j}, {int(_CORPUS.classes[j])})")
        ex.execute_one("SELECT label FROM v WHERE id = 1 AND view = 2")
    assert ex.log.commits == 2


# ---------------------------------------------------------------------------
# sessions, no sockets
# ---------------------------------------------------------------------------

def test_session_insert_then_select_sees_own_commit():
    ex = _executor(group_commit=64)
    s = TD.Session(ex)
    i, c = 7, int(_CORPUS.classes[7])
    s.execute(f"INSERT INTO t (id, class) VALUES ({i}, {c})")
    assert ex.log.has_pending("t")
    rows = s.execute_one(f"SELECT id FROM v WHERE class = {c}").rows
    assert [i] in [[r[0]] for r in rows]
    assert not ex.log.has_pending("t") and ex.log.commits == 1


def test_point_read_carries_the_pinned_epoch():
    ex = _executor(group_commit=2)
    s = TD.Session(ex)
    for j in range(4):
        s.execute(f"INSERT INTO t (id, class) VALUES "
                  f"({j}, {int(_CORPUS.classes[j])})")
    assert ex.log.commits == 2
    assert s.execute_one(
        "SELECT label FROM v WHERE id = 1 AND view = 2").epoch == 2


def test_sessions_have_private_prepared_namespaces():
    ex = _executor()
    s1, s2 = TD.Session(ex), TD.Session(ex)
    s1.execute("PREPARE pt AS SELECT label FROM v WHERE id = ? AND view = ?")
    s2.execute("PREPARE pt AS SELECT id FROM v WHERE class = ?")
    r1 = s1.execute_prepared("pt", [3, 1])
    r2 = s2.execute_prepared("pt", [2])
    assert tuple(r1.columns) == ("label",) and tuple(r2.columns) == ("id",)
    assert "pt" not in ex.prepared and s1.session_id != s2.session_id


# ---------------------------------------------------------------------------
# over the wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client_pkg", [RD, TD], ids=["ref-client",
                                                      "port-client"])
def test_server_ddl_dml_select_roundtrip(client_pkg):
    handle = TD.start_server_thread(TD.Executor(device="cpu"))
    try:
        with client_pkg.SqlClient.connect(*handle.address) as c:
            c.run("CREATE TABLE papers FROM CORPUS synthetic "
                  "WITH (scale = 0.08); "
                  "CREATE CLASSIFICATION VIEW topics ON papers "
                  "USING MODEL svm WITH (policy = hybrid)")
            epoch0 = c.ping()
            c.run("INSERT INTO papers (id, label) VALUES (3, 1)")
            res = c.run_one("SELECT id, label FROM topics WHERE id = 3")
            assert res.rows and res.rows[0][0] == 3
            assert res.epoch == epoch0 + 1 and c.ping() == epoch0 + 1
    finally:
        handle.stop()


def test_reference_client_decodes_the_port_server_as_the_reference():
    """The same statements through a reference client, once against the
    reference's server and once against the port's: equal decoded
    results (columns, rows, epochs, plans, tiers) and equal typed rows."""
    script = ["INSERT INTO t (id, class) VALUES (1, 2), (5, 0), (9, 3)",
              "SELECT id, view, label FROM v WHERE id = 5",
              "SELECT label FROM v WHERE id = 9 AND view = 3",
              "SELECT id, class FROM v WHERE id IN (1, 5, 9)",
              "SELECT count(*) FROM v WHERE class = 2",
              "SELECT id FROM v WHERE class = 0 LIMIT 5",
              "SELECT id, margin FROM v WHERE id = 1 AND view = 2",
              "EXPLAIN SELECT label FROM v WHERE id = 9 AND view = 3",
              "SHOW VIEWS", "SHOW TABLES", "SHOW STORAGE"]
    got = {}
    for key, pkg in (("ref", RD), ("port", TD)):
        handle = pkg.start_server_thread(_executor(group_commit=2, pkg=pkg))
        try:
            with RD.SqlClient.connect(*handle.address) as c:
                c.prepare("pt", "SELECT label FROM v WHERE id = ? AND "
                          "view = ?")
                out = [c.run_one(sql) for sql in script]
                out.append(c.run_prepared("pt", [5, 1]))
                got[key] = [(r.columns, r.rows, r.epoch, r.plan, r.tiers,
                             r.typed_rows()) for r in out]
                with pytest.raises(RD.ServerError) as e:
                    c.run("SELECT label FROM nope WHERE id = 1")
                got[key].append((e.value.error_type, str(e.value)))
        finally:
            handle.stop()
    assert got["port"] == got["ref"]


def test_statement_error_keeps_the_session_alive():
    handle = TD.start_server_thread(_executor())
    try:
        with TD.SqlClient.connect(*handle.address) as c:
            with pytest.raises(TD.ServerError):
                c.run("SELECT label FROM nope WHERE id = 1")
            sid = c.session_id
            res = c.run_one("SELECT label FROM v WHERE id = 1 AND view = 0")
            assert res.rows and c.session_id == sid
    finally:
        handle.stop()


def test_statement_error_carries_type_and_logs_server_side(caplog):
    handle = TD.start_server_thread(_executor())
    try:
        with TD.SqlClient.connect(*handle.address) as c:
            with caplog.at_level(logging.WARNING,
                                 logger="repro_torch.rdbms.server"):
                with pytest.raises(TD.ServerError) as ei:
                    c.run("SELECT label FROM nope WHERE id = 1")
            assert ei.value.error_type == "PlanError"
            assert str(ei.value).startswith("PlanError: ")
            logged = [r for r in caplog.records
                      if "statement failed" in r.getMessage()]
            assert logged and "PlanError" in logged[0].getMessage()
            assert str(c.session_id) in logged[0].getMessage()
    finally:
        handle.stop()


def test_wire_sessions_have_private_prepared_namespaces():
    handle = TD.start_server_thread(_executor())
    host, port = handle.address
    try:
        with TD.SqlClient.connect(host, port) as c1, \
                TD.SqlClient.connect(host, port) as c2:
            c1.prepare("pt", "SELECT label FROM v WHERE id = ? AND view = ?")
            c2.prepare("pt", "SELECT id FROM v WHERE class = ?")
            assert c1.run_prepared("pt", [3, 1]).columns == ["label"]
            assert c2.run_prepared("pt", [2]).columns == ["id"]
            with pytest.raises(TD.ServerError):
                c1.run_prepared("pt", [2])
    finally:
        handle.stop()


def test_bind_failure_raises():
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    try:
        with pytest.raises(RuntimeError, match="bind"):
            TD.start_server_thread(TD.Executor(device="cpu"),
                                   host="127.0.0.1", port=port)
    finally:
        blocker.close()


def test_server_needs_a_gpu_unless_given_an_executor():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: Executor() runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.SqlServer()


# ---------------------------------------------------------------------------
# the acceptance shape: concurrent swarm == serial WAL replay
# ---------------------------------------------------------------------------

def _swarm(ex, workers=8, ops=30, read_frac=0.7, seed=500):
    handle = TD.start_server_thread(ex)
    host, port = handle.address
    n, k = _CORPUS.features.shape[0], _CORPUS.num_classes
    errors = []
    start = threading.Barrier(workers, timeout=JOIN_S)

    def worker(idx):
        rng = np.random.default_rng(seed + idx)
        try:
            with TD.SqlClient.connect(host, port) as c:
                c.prepare("pt",
                          "SELECT label FROM v WHERE id = ? AND view = ?")
                start.wait()
                for _ in range(ops):
                    i = int(rng.integers(0, n))
                    if rng.random() < read_frac:
                        c.run_prepared("pt", [i, int(rng.integers(0, k))])
                    else:
                        c.run(f"INSERT INTO t (id, class) VALUES "
                              f"({i}, {int(_CORPUS.classes[i])})")
        except Exception as e:              # noqa: BLE001
            errors.append((idx, e))

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(workers)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)          # interleave the threads finely
    try:
        for t in threads:
            t.start()
        _join_all(threads)
    finally:
        sys.setswitchinterval(switch)
        handle.stop()
    assert not errors, errors
    ex.execute_one("COMMIT")
    return list(ex.log.history)


def _same_facades(fa, fb, k):
    assert np.array_equal(fa.counts(), fb.counts())
    for v in range(k):
        assert np.array_equal(np.sort(fa.members(v)),
                              np.sort(fb.members(v))), v
    assert np.array_equal(fa.engine.lw, fb.engine.lw)
    assert np.array_equal(fa.engine.hw, fb.engine.hw)
    assert np.array_equal(fa.engine.reorg_counts, fb.engine.reorg_counts)


def test_concurrent_swarm_equals_serial_replay():
    ex = _executor(group_commit=8)
    history = _swarm(ex)
    serial = _executor(group_commit=len(history) + 1)
    TD.UpdateLog.replay_into(history, serial.catalog)
    ref = _executor(group_commit=len(history) + 1, pkg=RD)
    RD.UpdateLog.replay_into(
        [RD.WalRecord(r.lsn, r.op, r.table, r.entity_id, r.label)
         for r in history], ref.catalog)
    k = _CORPUS.num_classes
    f_c = ex.catalog.view("v").facade
    _same_facades(f_c, serial.catalog.view("v").facade, k)
    _same_facades(f_c, ref.catalog.view("v").facade, k)
    assert f_c.engine.check_consistent()


def test_concurrent_point_reads_inside_the_shared_gate():
    """Many sessions reading at once, no writer: the shared gate lets them
    in together, and every answer equals the serial one."""
    ex = _executor(group_commit=8)
    n, k = _CORPUS.features.shape[0], _CORPUS.num_classes
    for j in range(0, 64):
        ex.execute_one(f"INSERT INTO t (id, class) VALUES "
                       f"({j}, {int(_CORPUS.classes[j])})")
    ex.execute_one("COMMIT")
    f = ex.catalog.view("v").facade
    want = {(i, v): int(f.engine.labels_of(i)[v])
            for i in range(0, n, 7) for v in range(k)}
    acq0 = ex.metrics.counter("gate.shared_acquisitions").value
    errors, got = [], {}
    barrier = threading.Barrier(16, timeout=JOIN_S)

    def reader(idx):
        s = TD.Session(ex)
        try:
            s.execute("PREPARE pt AS SELECT label FROM v WHERE id = ? "
                      "AND view = ?")
            barrier.wait()
            for (i, v) in list(want)[idx::16]:
                got[(i, v)] = s.execute_prepared("pt", [i, v]).rows[0][0]
        except Exception as e:              # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(i,), daemon=True)
               for i in range(16)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        _join_all(threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors
    assert got == want
    assert ex.metrics.counter("gate.shared_acquisitions").value - acq0 \
        == len(want)
    assert ex.log.commits == 8


# ---------------------------------------------------------------------------
# executor surfaces: statement traces, EXPLAIN ANALYZE, SHOW METRICS/COST
# (tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_statement_trace_phases():
    ex = _obs_executor()
    res = ex.execute_one("SELECT id, label FROM v WHERE id = 3")
    assert res.trace is not None and res.trace.name == "statement"
    names = [c.name for c in res.trace.children]
    assert "parse" in names and "execute" in names and "gate.wait" in names
    exec_children = [c.name for c in res.trace.find("execute").children]
    assert "plan" in exec_children and "probe" in exec_children
    assert res.trace.t1 is not None


def test_statement_counters_and_errors():
    ex = _obs_executor()
    before = ex.metrics.counter("statements").value
    errs = ex.metrics.counter("statements.errors").value
    ex.execute_one("SELECT id, label FROM v WHERE id = 1")
    with pytest.raises(SqlError):
        ex.execute_one("SELECT id, label FROM nosuch WHERE id = 1")
    assert ex.metrics.counter("statements").value == before + 2
    assert ex.metrics.counter("statements.errors").value == errs + 1
    assert ex.metrics.counter("statements.select").value >= 2


def test_explain_analyze_tier_row_is_the_exact_facade_delta():
    ex = _obs_executor(memory_budget=0.25)
    try:
        f = ex.catalog.view("v").facade
        before = dict(f.tier_hits)
        res = ex.execute_one(
            "EXPLAIN ANALYZE SELECT id, label FROM v WHERE id IN (1, 2, 3)")
        after = dict(f.tier_hits)
        tier_row = next(r for r in res.rows if r[0] == "tiers")
        reported = dict(kv.split("=") for kv in tier_row[2].split(";"))
        for t in TIERS:
            assert int(reported[t]) == after[t] - before[t], (t, reported)
        assert sum(int(v) for v in reported.values()) == 3
        phases = [r[0].strip() for r in res.rows]
        assert "analyze" in phases and "probe" in phases and "epoch" in phases
        assert next(r for r in res.rows if r[0] == "rows")[2] == "3"
    finally:
        _close(ex)


def _close(ex):
    """Close the view's pool and the table's entity store (a temp file)."""
    ex.catalog.view("v").facade.engine.store.close()
    for t in ex.catalog.tables.values():
        for es in t.stores.values():
            es.close()


def test_explain_analyze_executes_dml():
    ex = _obs_executor()
    queued0 = ex.metrics.counter("wal.appends").value
    ex.execute_one("EXPLAIN ANALYZE INSERT INTO t VALUES (9, 1)")
    assert ex.metrics.counter("wal.appends").value == queued0 + 1
    ex.execute_one("EXPLAIN INSERT INTO t VALUES (10, 1)")
    assert ex.metrics.counter("wal.appends").value == queued0 + 1


def test_explain_analyze_flushes_read_your_writes():
    ex = _obs_executor()
    ex.execute_one("INSERT INTO t VALUES (11, 1)")
    assert ex.log.has_pending("t")
    ex.execute_one("EXPLAIN ANALYZE SELECT id, label FROM v WHERE id = 11")
    assert not ex.log.has_pending("t")


def test_show_metrics_and_snapshot_agree():
    ex = _obs_executor()
    res = ex.execute_one("SHOW METRICS")
    flat = dict(res.rows)
    snap = ex.metrics_snapshot()
    assert res.columns == ("metric", "value")
    assert flat["epoch"] == snap["epoch"] == ex.log.commits
    assert flat["counters.wal.commits"] == \
        snap["counters"]["wal.commits"] == ex.log.commits
    assert flat["counters.gate.exclusive_acquisitions"] == \
        snap["counters"]["gate.exclusive_acquisitions"]
    assert flat["view.v.policy"] == "hybrid"
    assert ex.metrics.counter("statements.show").value >= 1


def test_gate_wait_histograms_populated():
    ex = _obs_executor()
    ex.execute_one("SELECT id, label FROM v WHERE id = 1")
    snap = ex.metrics_snapshot()
    assert snap["histograms"]["gate.shared_wait_seconds"]["count"] >= 1
    assert snap["histograms"]["gate.exclusive_wait_seconds"]["count"] >= 8
    assert snap["counters"]["gate.shared_acquisitions"] >= 1


def test_show_cost_reports_modeled_vs_measured():
    ex = _obs_executor()
    ex.execute_one("UPDATE MODEL ON v")
    row = dict(zip(*(lambda r: (r.columns, r.rows[0]))(
        ex.execute_one("SHOW COST ON v"))))
    assert row["view"] == "v" and row["cost_mode"] == "modeled"
    assert int(row["reorgs"]) >= 1
    assert float(row["S_measured_mean_s"]) > 0
    if int(row["steps"]) and float(row["charge_modeled"]) > 0:
        assert float(row["seconds_per_charge"]) > 0


def test_show_cost_multiview_and_unknown_view():
    ex = TD.Executor(device="cpu")
    ex.execute_one("CREATE TABLE m FROM CORPUS cora_like WITH (scale = 0.05)")
    ex.execute_one("CREATE CLASSIFICATION VIEW mv ON m USING MODEL svm "
                   "WITH (k = 7, policy = hybrid, cost_mode = modeled)")
    for i in range(6):
        ex.execute_one(f"INSERT INTO m VALUES ({i}, {i % 7})")
    ex.execute_one("UPDATE MODEL ON mv")
    res = ex.execute_one("SHOW COST ON mv")
    assert [r[1] for r in res.rows] == list(range(7))
    with pytest.raises(SqlError):
        ex.execute_one("SHOW COST ON nosuch")


def test_slow_log_fires_above_threshold_only(caplog):
    ex = _obs_executor()
    with caplog.at_level(logging.WARNING, logger="repro_torch.obs.slowlog"):
        ex.slow_ms = 1e9
        ex.execute_one("SELECT id, label FROM v WHERE id = 1")
        assert not caplog.records
        ex.slow_ms = 0.0
        ex.execute_one("SELECT id, label FROM v WHERE id = 2")
    assert len(caplog.records) == 1
    msg = caplog.records[0].getMessage()
    assert "slow statement" in msg and "probe" in msg


def test_pool_read_spans_feed_registry():
    ex = _obs_executor(memory_budget=0.1)
    try:
        ex.execute_one("SELECT id, label FROM v WHERE label = 1")
        snap = ex.metrics_snapshot()
        st = snap["view.v"]["storage"]
        assert st["hits"] + st["misses"] + st["coalesced"] == st["probes"]
        if st["misses"]:
            assert snap["histograms"]["span.pool.read.seconds"]["count"] >= 1
    finally:
        _close(ex)


def test_wal_telemetry_counters():
    ex = _obs_executor()
    snap = ex.metrics_snapshot()
    assert snap["wal"]["commits"] == ex.log.commits == snap["epoch"]
    assert snap["counters"]["wal.appends"] == 8
    assert snap["histograms"]["wal.group_size"]["count"] == ex.log.commits


def test_telemetry_per_statement_by_counts():
    """Counterpart of the reference's overhead guard, by counts: N
    statements feed `statements` and the statement-time histogram N
    times, the per-kind counters sum to N, and the gate and WAL
    instruments move exactly with the acquisitions and commits."""
    ex = _obs_executor()
    snap0 = ex.metrics_snapshot()
    n = 0
    for i in range(20):
        ex.execute_one(f"SELECT id, label FROM v WHERE id = {i}")
        ex.execute_one(f"INSERT INTO t VALUES ({i}, 1)")
        n += 2
    snap = ex.metrics_snapshot()
    c0, c1 = snap0["counters"], snap["counters"]
    assert c1["statements"] - c0["statements"] == n
    assert (snap["histograms"]["statement.seconds"]["count"]
            - snap0["histograms"]["statement.seconds"]["count"]) == n
    assert (c1["statements.select"] - c0.get("statements.select", 0)
            + c1["statements.insert"] - c0["statements.insert"]) == n
    assert c1["wal.appends"] - c0["wal.appends"] == 20
    assert c1["wal.commits"] - c0["wal.commits"] == \
        snap["epoch"] - snap0["epoch"]
    acq = (c1["gate.shared_acquisitions"] + c1["gate.exclusive_acquisitions"]
           - c0["gate.shared_acquisitions"]
           - c0["gate.exclusive_acquisitions"])
    assert acq >= n


# ---------------------------------------------------------------------------
# server + wire + REPL surfaces
# ---------------------------------------------------------------------------

@pytest.fixture()
def served():
    ex = _obs_executor()
    handle = TD.start_server_thread(ex, log_statements=True)
    client = TD.SqlClient.connect(*handle.address)
    yield ex, client
    client.close()
    handle.stop()


def test_wire_metrics_roundtrip(served):
    ex, client = served
    client.run("SELECT id, label FROM v WHERE id = 1")
    snap = client.metrics()
    assert snap["epoch"] == ex.log.commits
    assert snap["counters"]["statements"] >= 1
    assert "view.v" in snap and snap["view.v"]["policy"] == "hybrid"
    assert isinstance(snap["histograms"]["statement.seconds"]["p99"],
                      (int, float))


def test_wire_results_carry_span_phases(served):
    _, client = served
    r = client.run_one("SELECT id, label FROM v WHERE id = 2")
    assert r.elapsed_us is not None and r.elapsed_us > 0
    assert "execute" in r.phases and "gate.wait" in r.phases
    assert client.last_elapsed_us is not None


def test_access_log_line_per_statement(served, caplog):
    _, client = served
    with caplog.at_level(logging.INFO, logger="repro_torch.rdbms.server"):
        client.run("SELECT id, label FROM v WHERE id = 1; "
                   "SELECT id, label FROM v WHERE id = 2")
    lines = [r.getMessage() for r in caplog.records
             if "kind=select" in r.getMessage()]
    assert len(lines) == 2
    assert all("session=" in ln and "elapsed_us=" in ln and "epoch=" in ln
               for ln in lines)


def test_repl_footer_reports_gate_and_execute_split():
    from repro_torch.rdbms.repl import repl
    out = io.StringIO()
    repl(_obs_executor(),
         stdin=io.StringIO("SELECT id, label FROM v WHERE id = 1;\n"),
         out=out)
    footer = next(ln for ln in out.getvalue().splitlines()
                  if ln.startswith("-- ") and "gate-wait" in ln)
    assert "ms (gate-wait" in footer and "execute" in footer
