"""The port's relational front end (`repro_torch.rdbms`, device="cpu") held
against the reference's (`repro.rdbms`): the parser, the planner's errors,
the `equals_direct` cases of tests/test_sql.py, the WAL and the wire
frames.

Every statement of a case goes to `repro.rdbms.Executor` and to the port's
`Executor(device="cpu")` (the `Twin` below), and each pair of `Result`s
must be equal: columns, rows, epochs, plans (kind, tier, touched-tuple
estimate, detail), tiers used. Cells compare exactly, type included,
except `margin` cells, which agree within the fp32 rounding bound of the
dot, |got − want| ≤ 2·(d + 1)·2⁻²⁴·(Σ_i |f_i·w_i| + |b|) (the bound of
tests/test_torch_eps_affine.py), and timing cells (`actual_us`), which
are wall times. Errors are equal in type name and message. Labels are
held exact: the North star's tie rule would excuse a mismatch whose
margin is within 1e-6·(‖f‖‖w‖ + |b|) of zero, and none is excused here.

Each `equals_direct` case also drives the port's own direct twin (the
same engine calls without SQL, the WAL's group commits mirrored), as the
reference test drives the reference's, and at the end the port's engine
state equals the reference's: labels and members in entity order,
counts, waters bit for bit, reorg counts, pending masks. The sharded case
needs the reference's `ShardedMultiViewHazy`, whose `shard_map(...,
check_rep=False)` jax 0.7 and later no longer take; the case renames the
keyword inside a `pytest.MonkeyPatch.context()` (ROADMAP R1), nothing in
`repro` changes.

The WAL files written by the two executors for one stream are byte for
byte equal, and each replays into the other package's catalog with the
same commit boundaries and end state. The wire frames of every `Result`
pair (trace left out: it is wall time) are byte for byte equal, and no
cell of a port `Result` is a torch value."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as RC                                     # noqa: E402
import repro.core.sharded as ref_sharded                    # noqa: E402
import repro.rdbms as RD                                    # noqa: E402
from repro.data import multiclass_corpus, synthetic_corpus  # noqa: E402
from repro.rdbms import server as RSV                       # noqa: E402
from repro.rdbms import wire as RW                          # noqa: E402

import repro_torch.core as TC                               # noqa: E402
import repro_torch.rdbms as TD                              # noqa: E402
from repro_torch.rdbms import server as TSV                 # noqa: E402
from repro_torch.rdbms import wire as TW                    # noqa: E402

GROUP = 8          # WAL group-commit size, as in tests/test_sql.py
TIMING_COLUMNS = ("actual_us", "S_measured_mean_s", "seconds_measured",
                  "seconds_per_charge")


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny CPU products: torch's threads only cost here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shard_map_check_vma(mp):
    """Test-local R1 shim: forward `check_rep` as `check_vma`."""
    orig = ref_sharded.shard_map

    def shim(*args, **kw):
        if "check_rep" in kw:
            kw["check_vma"] = kw.pop("check_rep")
        return orig(*args, **kw)

    mp.setattr(ref_sharded, "shard_map", shim)


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------

def _ast(node):
    """A parse tree as nested tuples of (class name, fields): the two
    packages' AST classes are distinct, their shapes must not be."""
    if dataclasses.is_dataclass(node):
        return (type(node).__name__,
                tuple((f.name, _ast(getattr(node, f.name)))
                      for f in dataclasses.fields(node)))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, tuple(_ast(x) for x in node))
    if isinstance(node, dict):
        return ("dict", tuple((k, _ast(v)) for k, v in node.items()))
    return (type(node).__name__, node)


def margin_bound(F, w, b):
    """The fp32 rounding bound of f·w − b for every row of F."""
    mass = np.abs(F.astype(np.float64) * np.asarray(w, np.float64)).sum(1)
    return 2 * (F.shape[1] + 1) * 2.0 ** -24 * (mass + abs(float(b)))


def _is_host_value(x) -> bool:
    return x is None or isinstance(x, (bool, int, float, str, np.generic))


def same_result(r, t, tol=0.0):
    """Equal `Result`s: see the module docstring. `tol` bounds margins."""
    assert t.columns == r.columns
    assert t.epoch == r.epoch
    assert t.tiers_used == r.tiers_used
    assert (t.plan is None) == (r.plan is None)
    if r.plan is not None:
        assert dataclasses.astuple(t.plan) == dataclasses.astuple(r.plan)
    assert len(t.rows) == len(r.rows)
    for rr, tr in zip(r.rows, t.rows):
        assert len(rr) == len(tr)
        for col, a, b in zip(r.columns, rr, tr):
            assert _is_host_value(b), (col, type(b))
            if col in TIMING_COLUMNS:
                continue
            assert type(b) is type(a), (col, type(a), type(b))
            if col == "margin":
                assert abs(b - a) <= tol, (col, a, b, tol)
            else:
                assert b == a, (col, a, b)


class Twin:
    """The same statements through the reference executor and the port's.
    `setup(catalog)` registers the tables and views on each side."""

    def __init__(self, setup, *, group_commit=GROUP, wal=None, clock=None,
                 tol=0.0):
        self.rcat, self.tcat = RD.Catalog(), TD.Catalog(device="cpu")
        if clock is not None:
            self.rcat.clock = self.tcat.clock = clock
        setup(self.rcat)
        setup(self.tcat)
        self.rex = RD.Executor(self.rcat, group_commit=group_commit,
                               wal_path=None if wal is None else wal[0])
        self.tex = TD.Executor(self.tcat, group_commit=group_commit,
                               wal_path=None if wal is None else wal[1])
        self.tol = tol
        self.results = []

    def execute_one(self, sql):
        r = self.rex.execute_one(sql)
        t = self.tex.execute_one(sql)
        same_result(r, t, self.tol)
        self.results.append((r, t))
        return t

    def raises(self, sql):
        """Both sides raise, with the same error type and message."""
        with pytest.raises(Exception) as er:
            self.rex.execute_one(sql)
        with pytest.raises(Exception) as et:
            self.tex.execute_one(sql)
        assert type(et.value).__name__ == type(er.value).__name__
        assert str(et.value) == str(er.value)
        return et.value

    def facades(self, view="v"):
        return self.rcat.view(view).facade, self.tcat.view(view).facade


def _frame(server, wire, res):
    return wire.encode_frame(server._result_payload(
        dataclasses.replace(res, trace=None)))


def assert_same_frames(tw):
    """The wire frames of every result pair are byte for byte equal, and
    the reference's encoder gives the port's payload the same bytes."""
    assert tw.results
    for r, t in tw.results:
        want = _frame(RSV, RW, r)
        assert _frame(TSV, TW, t) == want
        assert _frame(RSV, RW, t) == want


def _labels_in_entity_order(perm, labels_sorted):
    perm = np.asarray(perm.cpu() if torch.is_tensor(perm) else perm)
    lab = np.asarray(labels_sorted.cpu() if torch.is_tensor(labels_sorted)
                     else labels_sorted)
    out = np.empty_like(lab)
    if lab.ndim == 1:
        out[perm] = lab
    else:
        np.put_along_axis(out, perm, lab, 1)
    return out


def same_hazy_state(re, te):
    """Single-view engine state: labels and members in entity order,
    counts, waters bit for bit, reorgs, pending."""
    assert te.all_members() == re.all_members()
    assert np.array_equal(_labels_in_entity_order(te.perm, te.labels_sorted),
                          _labels_in_entity_order(re.perm, re.labels_sorted))
    assert np.array_equal(np.sort(te.members()), np.sort(re.members()))
    assert (te.waters.lw, te.waters.hw) == (re.waters.lw, re.waters.hw)
    assert te.skiing.reorgs == re.skiing.reorgs
    assert (te._pending is None) == (re._pending is None)
    assert te.stats.rounds == re.stats.rounds


def same_multiview_state(re, te):
    assert np.array_equal(te.all_members(), re.all_members())
    assert np.array_equal(_labels_in_entity_order(te.perm, te.labels_sorted),
                          _labels_in_entity_order(re.perm, re.labels_sorted))
    for v in range(re.k):
        assert np.array_equal(np.sort(te.members(v)),
                              np.sort(re.members(v))), v
    for name in ("lw", "hw", "pending", "reorg_counts"):
        assert np.array_equal(getattr(te, name), getattr(re, name)), name


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

STATEMENTS = [
    """CREATE TABLE papers FROM CORPUS cora_like WITH (scale = 0.1);
       CREATE CLASSIFICATION VIEW v ON papers USING MODEL svm
           WITH (policy = hybrid, k = 16, buffer_frac = 0.05, p = inf)""",
    """INSERT INTO t (id, label) VALUES (3, 1), (4, -1);
       UPDATE t SET label = -1 WHERE id = 5;
       UPDATE MODEL ON v;
       DELETE FROM t WHERE id = 9;
       SELECT id, view, label FROM v WHERE id IN (1, 2) AND view = 3;
       SELECT COUNT(*) FROM v WHERE label = 1;
       SELECT id, margin FROM v ORDER BY margin DESC LIMIT 7;
       EXPLAIN SELECT label FROM v WHERE id = 0""",
    "INSERT INTO t (id, class) VALUES (1, 2), (3, 0)",
    "INSERT INTO t VALUES (9, 1)",
    "SELECT id, class FROM w WHERE id = 1",
    "SELECT id FROM v WHERE class = 1 AND label = -1 LIMIT 5",
    "SELECT count(*) FROM v",
    "SELECT id, margin FROM v ORDER BY margin ASC LIMIT 3",
    "EXPLAIN ANALYZE SELECT id, label FROM v WHERE id IN (1, 2, 3)",
    "EXPLAIN ANALYZE INSERT INTO t VALUES (9, 1)",
    "PREPARE pt AS SELECT label FROM v WHERE id = ? AND view = ?",
    "PREPARE upd AS UPDATE t SET label = ? WHERE id = ?",
    "EXECUTE pt (3, 1); EXECUTE cnt (-1)",
    "COMMIT",
    "SHOW TABLES; SHOW VIEWS; SHOW STORAGE; SHOW METRICS; SHOW SCHEDULE",
    "SHOW COST ON v",
    """CREATE CLASSIFICATION VIEW b ON a USING MODEL logistic
           WITH (target_lag = 'downstream', memory_budget = 0.25,
                 page_bytes = 1024, prefetch = on, engine = sharded,
                 cap_frac = 0.5, cost_mode = modeled)""",
    "ALTER VIEW c SET (target_lag = '3 s'); ALTER VIEW a SUSPEND; "
    "ALTER VIEW a RESUME; ALTER VIEW a REFRESH",
]

BAD = [
    "SELECT bogus FROM v",
    "SELECT label FROM v WHERE label = 2",
    "SELECT id FROM v ORDER BY id",
    "UPDATE t SET margin = 1 WHERE id = 0",
    "INSERT INTO t (label, id) VALUES (1, 1)",
    "CREATE VIEW v ON t USING MODEL svm",
    "SELECT label FROM",
    "SELECT label FROM v WHERE id = ?",
    "SELECT label FROM v WHERE id = 1 @",
    "ALTER VIEW v FLY",
]


@pytest.mark.parametrize("sql", STATEMENTS)
def test_parse_equals_reference(sql):
    assert [_ast(s) for s in TD.parse(sql)] == \
        [_ast(s) for s in RD.parse(sql)]


@pytest.mark.parametrize("bad", BAD)
def test_parse_errors_equal_reference(bad):
    with pytest.raises((RD.ParseError, RD.LexError)) as er:
        RD.parse(bad)
    with pytest.raises((TD.ParseError, TD.LexError)) as et:
        TD.parse(bad)
    assert type(et.value).__name__ == type(er.value).__name__
    assert str(et.value) == str(er.value)


def test_parse_create_statements():
    ct, cv = TD.parse(STATEMENTS[0])
    assert ct == TD.CreateTable("papers", "cora_like", {"scale": 0.1})
    assert cv.name == "v" and cv.table == "papers" and cv.model == "svm"
    assert cv.options == {"policy": "hybrid", "k": 16, "buffer_frac": 0.05,
                          "p": float("inf")}
    assert isinstance(cv.options["k"], int)


def test_same_public_names():
    assert sorted(n for n in dir(TD) if not n.startswith("_")) == \
        sorted(n for n in dir(RD) if not n.startswith("_"))
    import repro.scheduler as RS
    import repro_torch.scheduler as TS
    assert TS.__all__ == RS.__all__


# ---------------------------------------------------------------------------
# equals_direct: single view (tests/test_sql.py)
# ---------------------------------------------------------------------------

class DirectMirror:
    """The WAL's group-commit semantics over direct engine calls (flush at
    GROUP records, before reads and UPDATE MODEL; DELETE splits the
    batch)."""

    def __init__(self, insert_batch, delete_fn=None):
        self.pending = []
        self.insert_batch = insert_batch
        self.delete_fn = delete_fn

    def dml(self, entity_id, label, op="insert"):
        self.pending.append((op, entity_id, label))
        if len(self.pending) >= GROUP:
            self.flush()

    def flush(self):
        batch = []
        for op, i, y in self.pending:
            if op == "delete":
                if batch:
                    self.insert_batch([b[0] for b in batch],
                                      [b[1] for b in batch])
                    batch = []
                self.delete_fn(i)
            else:
                batch.append((i, y))
        if batch:
            self.insert_batch([b[0] for b in batch], [b[1] for b in batch])
        self.pending = []


def _single_view(policy, c):
    def setup(catalog):
        catalog.register_table("t", c.features, truth=c.labels)
        catalog.create_view("v", "t", "svm",
                            {"policy": policy, "p": 2, "q": 2,
                             "buffer_frac": (0.02 if policy == "hybrid"
                                             else 0.0),
                             "cost_mode": "modeled"})
    return setup


def _direct_view(policy, c):
    return TC.ClassificationView(
        c.features, method="svm", policy=policy, norm=(2.0, 2.0), lr=0.1,
        l2=1e-4, alpha=1.0, buffer_frac=0.02 if policy == "hybrid" else 0.0,
        cost_mode="modeled", device="cpu")


@pytest.mark.parametrize("policy", ["eager", "lazy", "hybrid"])
def test_sql_equals_direct_single_view(policy, tmp_path):
    c = synthetic_corpus("eqv", 400, 24, seed=2)
    wal = (str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl"))
    tw = Twin(_single_view(policy, c), wal=wal)
    direct = _direct_view(policy, c)
    mirror = DirectMirror(
        lambda ids, ys: direct.insert_examples(ids, ys, batched=True))
    n = c.features.shape[0]
    rng = np.random.default_rng(31)
    for step in range(240):
        u = rng.random()
        if u < 0.60:                                       # INSERT batch
            m = int(rng.integers(1, 5))
            rows = [int(rng.integers(0, n)) for _ in range(m)]
            rows = [(i, int(c.labels[i])) for i in rows]
            tw.execute_one("INSERT INTO t (id, label) VALUES "
                           + ", ".join(f"({i}, {y})" for i, y in rows))
            for i, y in rows:
                mirror.dml(i, float(y))
        elif u < 0.72:                                     # UPDATE = example
            i = int(rng.integers(0, n))
            y = -int(c.labels[i])
            tw.execute_one(f"UPDATE t SET label = {y} WHERE id = {i}")
            mirror.dml(i, float(y), op="update")
        elif u < 0.88:                                     # point SELECT
            i = int(rng.integers(0, n))
            got = tw.execute_one(
                f"SELECT label FROM v WHERE id = {i}").rows[0][0]
            mirror.flush()
            if policy == "hybrid":
                want, _ = direct.engine.hybrid_label(i)
            else:
                want = direct.engine.label(i)
            assert got == want, (step, i)
        elif u < 0.95:                                     # COUNT
            got = tw.execute_one(
                "SELECT count(*) FROM v WHERE label = 1").rows[0][0]
            mirror.flush()
            assert got == direct.engine.all_members(), step
        else:                                              # UPDATE MODEL
            tw.execute_one("UPDATE MODEL ON v")
            mirror.flush()
            direct.engine.apply_model(direct.model)
    tw.execute_one("COMMIT")
    mirror.flush()
    rf, tf = tw.facades()
    same_hazy_state(rf.view.engine, tf.view.engine)
    same_hazy_state(direct.engine, tf.view.engine)
    assert np.array_equal(tf.view.model.w, rf.view.model.w)
    assert tf.view.engine.check_consistent()
    assert tf.tier_hits == rf.tier_hits
    assert_same_frames(tw)
    tw.rex.log.close()
    tw.tex.log.close()
    with open(wal[0], "rb") as a, open(wal[1], "rb") as b:
        assert a.read() == b.read()


def test_sql_equals_direct_single_view_with_delete():
    c = synthetic_corpus("eqv", 400, 24, seed=2)
    tw = Twin(_single_view("eager", c))
    direct = _direct_view("eager", c)
    direct_log = []

    def direct_insert(ids, ys):
        direct_log.extend(zip(ids, ys))
        direct.insert_examples(ids, ys, batched=True)

    def direct_delete(eid):
        keep = [(i, y) for i, y in direct_log if i != eid]
        direct_log[:] = keep
        direct.examples = [(direct.F[i], y) for i, y in keep]
        direct.retrain_from_scratch()

    mirror = DirectMirror(direct_insert, delete_fn=direct_delete)
    n = c.features.shape[0]
    rng = np.random.default_rng(5)
    for _ in range(60):
        i = int(rng.integers(0, n))
        y = int(c.labels[i])
        tw.execute_one(f"INSERT INTO t (id, label) VALUES ({i}, {y})")
        mirror.dml(i, float(y))
        if rng.random() < 0.1:
            j = int(rng.integers(0, n))
            tw.execute_one(f"DELETE FROM t WHERE id = {j}")
            mirror.dml(j, 0.0, op="delete")
    tw.execute_one("COMMIT")
    mirror.flush()
    rf, tf = tw.facades()
    same_hazy_state(rf.view.engine, tf.view.engine)
    same_hazy_state(direct.engine, tf.view.engine)
    assert_same_frames(tw)


# ---------------------------------------------------------------------------
# equals_direct: k = 16 one-vs-all views over MultiViewEngine
# ---------------------------------------------------------------------------

K = 16


@pytest.mark.parametrize("policy", ["eager", "lazy", "hybrid"])
def test_sql_equals_direct_multiclass_k16(policy):
    c = multiclass_corpus("eqk", 360, 24, K, seed=4)

    def setup(catalog):
        catalog.register_table("t", c.features, truth=c.classes,
                               num_classes=K)
        catalog.create_view("v", "t", "svm",
                            {"policy": policy, "k": K, "p": 2, "q": 2,
                             "cost_mode": "modeled"})

    tw = Twin(setup)
    direct = TC.MulticlassView(
        c.features, K, policy=policy, lr=0.1, l2=1e-4, alpha=1.0, p=2.0,
        q=2.0, cost_mode="modeled",
        buffer_frac=0.01 if policy == "hybrid" else 0.0, vectorized=True,
        device="cpu")
    mirror = DirectMirror(lambda ids, ys: direct.insert_examples(
        [int(i) for i in ids], [int(y) for y in ys]))
    n = c.features.shape[0]
    rng = np.random.default_rng(77)
    for step in range(160):
        u = rng.random()
        if u < 0.62:                                       # INSERT batch
            rows = [int(rng.integers(0, n))
                    for _ in range(int(rng.integers(1, 5)))]
            rows = [(i, int(c.classes[i])) for i in rows]
            tw.execute_one("INSERT INTO t (id, class) VALUES "
                           + ", ".join(f"({i}, {cl})" for i, cl in rows))
            for i, cl in rows:
                mirror.dml(i, cl)
        elif u < 0.78:                                     # one-view point
            i = int(rng.integers(0, n))
            v = int(rng.integers(0, K))
            got = tw.execute_one(
                f"SELECT label FROM v WHERE id = {i} AND view = {v}"
            ).rows[0][0]
            mirror.flush()
            if policy == "hybrid":
                want, _ = direct.engine.hybrid_label(v, i)
            else:
                want = direct.engine.label(v, i)
            assert got == want, (step, i, v)
        elif u < 0.88:                                     # all-views point
            i = int(rng.integers(0, n))
            got = [r[2] for r in tw.execute_one(
                f"SELECT id, view, label FROM v WHERE id = {i}").rows]
            mirror.flush()
            if policy == "hybrid":
                want = direct.engine.hybrid_labels_of(i)[0]
            else:
                want = direct.engine.labels_of(i)
            assert np.array_equal(got, want), (step, i)
        elif u < 0.95:                                     # COUNT one class
            v = int(rng.integers(0, K))
            got = tw.execute_one(
                f"SELECT count(*) FROM v WHERE class = {v}").rows[0][0]
            mirror.flush()
            assert got == direct.engine.all_members()[v], step
        else:                                              # UPDATE MODEL
            tw.execute_one("UPDATE MODEL ON v")
            mirror.flush()
            direct.engine.apply_models(direct.W, direct.b)
    tw.execute_one("COMMIT")
    mirror.flush()
    rf, tf = tw.facades()
    same_multiview_state(rf.mc.engine, tf.mc.engine)
    same_multiview_state(direct.engine, tf.mc.engine)
    assert tf.mc.engine.check_consistent()
    assert tf.tier_hits == rf.tier_hits
    assert_same_frames(tw)


# ---------------------------------------------------------------------------
# equals_direct: engine = sharded (R1 shim on the reference side)
# ---------------------------------------------------------------------------

def test_sql_equals_direct_sharded():
    from repro_torch.core.sharded import ShardedMultiViewHazy
    from repro_torch.core.waters import holder_M
    from repro_torch.kernels.band_reclassify import kernel
    k, n, d = 4, 256, 16
    c = multiclass_corpus("eqs", n, d, k, seed=9)
    F = np.ascontiguousarray(c.features, np.float32)

    def setup(catalog):
        catalog.register_table("t", F, truth=c.classes, num_classes=k)
        catalog.create_view("v", "t", "svm",
                            {"engine": "sharded", "k": k, "p": 2, "q": 2,
                             "cap_frac": 0.5})

    with pytest.MonkeyPatch.context() as mp:
        shard_map_check_vma(mp)
        tw = Twin(setup)
        driver = ShardedMultiViewHazy(n=n, d=d, k=k, M=holder_M(F, 2.0),
                                      p=2.0, cap_frac=0.5, device="cpu")
        state = driver.init_state(F)
        W = np.zeros((k, d), np.float32)
        b = np.zeros(k, np.float64)
        lr, l2 = 0.1, 1e-4
        pending = []

        def flush():
            nonlocal state, W, b
            if not pending:
                return
            for i, cls in pending:
                f = F[i]
                y = np.where(np.arange(k) == cls, 1.0, -1.0)
                z = W @ f - b.astype(np.float32)
                g = np.where(y * z.astype(np.float64) < 1.0, -y, 0.0)
                W = W * (1.0 - lr * l2)
                W -= (lr * g).astype(np.float32)[:, None] * f[None, :]
                b = b - lr * (-g)
            state = driver.apply_models(state, W, b)
            pending.clear()

        rng = np.random.default_rng(123)
        for _ in range(10):
            rows = [int(rng.integers(0, n)) for _ in range(GROUP)]
            rows = [(i, int(c.classes[i])) for i in rows]
            tw.execute_one("INSERT INTO t (id, class) VALUES "
                           + ", ".join(f"({i}, {cl})" for i, cl in rows))
            for i, cl in rows:
                pending.append((i, cl))
                if len(pending) >= GROUP:
                    flush()
            i = int(rng.integers(0, n))
            got = [r[2] for r in tw.execute_one(
                f"SELECT id, view, label FROM v WHERE id = {i}").rows]
            flush()
            want, _ = driver.hybrid_labels_of(state, W, b, i)
            assert np.array_equal(got, want), i
            cnt = tw.execute_one(
                f"SELECT count(*) FROM v WHERE class = {i % k}")
            assert cnt.rows[0][0] == driver.all_members(state)[i % k]
        tw.execute_one("COMMIT")
        flush()
        rf, tf = tw.facades()
        launches = kernel.multiview_band_reclassify.launches
        assert np.array_equal(tf.counts(), driver.all_members(state))
        assert np.array_equal(tf.counts(), rf.counts())
        assert np.array_equal(tf.state.labels.numpy(),
                              state.labels.numpy())
        assert np.array_equal(tf.state.gids.numpy(), state.gids.numpy())
        ref_lab = np.asarray(rf.state.labels)
        ref_gid = np.asarray(rf.state.gids)
        lab_t = np.empty_like(ref_lab)
        lab_t[:, tf.state.gids.numpy()] = tf.state.labels.numpy()
        lab_r = np.empty_like(ref_lab)
        lab_r[:, ref_gid] = ref_lab
        assert np.array_equal(lab_t, lab_r)
        for name in ("lw", "hw"):
            assert np.array_equal(getattr(tf.driver, name),
                                  getattr(rf.driver, name)), name
        assert tf.driver.skiing.reorgs == rf.driver.skiing.reorgs
        assert np.array_equal(tf.W, rf.W) and np.array_equal(tf.b, rf.b)
        # the CPU runs the plain version: nothing counts as a launch
        assert kernel.multiview_band_reclassify.launches == launches
        assert_same_frames(tw)


# ---------------------------------------------------------------------------
# reads, EXPLAIN, prepared statements, storage (tests/test_sql.py)
# ---------------------------------------------------------------------------

def _warm(policy="hybrid", seed=21, n=400, d=16, **view):
    c = synthetic_corpus("scan", n, d, seed=seed)

    def setup(catalog):
        catalog.register_table("t", c.features, truth=c.labels)
        catalog.create_view("v", "t", "svm",
                            {"policy": policy, "p": 2, "q": 2,
                             "cost_mode": "modeled", **view})

    tw = Twin(setup)
    rng = np.random.default_rng(seed)
    for _ in range(8):
        rows = [int(rng.integers(0, n)) for _ in range(GROUP)]
        tw.execute_one("INSERT INTO t (id, label) VALUES " + ", ".join(
            f"({i}, {int(c.labels[i])})" for i in rows))
    tw.execute_one("COMMIT")
    return c, tw


def test_hybrid_point_selects_tiers_and_explain_equal_reference():
    c, tw = _warm(seed=6, buffer_frac=0.02)
    rf, tf = tw.facades()
    n = c.features.shape[0]
    rng = np.random.default_rng(8)
    for _ in range(150):
        i = int(rng.integers(0, n))
        tw.execute_one(f"SELECT label FROM v WHERE id = {i}")
    assert tf.tier_hits == rf.tier_hits and tf.tier_hits["water"] > 0
    assert tf.disk_touches == rf.disk_touches == tf.tier_hits["disk"]
    for sql in ("EXPLAIN SELECT label FROM v WHERE id = 7",
                "EXPLAIN SELECT id FROM v WHERE label = 1",
                "EXPLAIN SELECT count(*) FROM v",
                "EXPLAIN SELECT id, margin FROM v ORDER BY margin DESC "
                "LIMIT 9",
                "EXPLAIN INSERT INTO t (id, label) VALUES (1, 1)",
                "EXPLAIN UPDATE MODEL ON v"):
        res = tw.execute_one(sql)
        assert res.columns[0] == "step"
    assert tf.tier_hits == rf.tier_hits
    m = tf.view.model
    truth = np.where(c.features @ m.w - m.b >= 0, 1, -1)
    for i in range(0, n, 17):
        assert tw.execute_one(
            f"SELECT label FROM v WHERE id = {i}").rows[0][0] == truth[i]


def test_scans_counts_topk_equal_reference():
    c, tw = _warm()
    n = c.features.shape[0]
    rf, tf = tw.facades()
    m = tf.view.model
    tw.tol = float(margin_bound(c.features, m.w, m.b).max())
    got = tw.execute_one("SELECT id FROM v WHERE label = 1").rows
    assert sorted(r[0] for r in got) == sorted(
        int(x) for x in tf.view.engine.members())
    neg = tw.execute_one("SELECT id, label FROM v WHERE label = -1 LIMIT 20")
    assert all(r[1] == -1 for r in neg.rows)
    tw.execute_one("SELECT count(*) FROM v WHERE label = 1")
    tw.execute_one("SELECT count(*) FROM v WHERE label = -1")
    assert tw.execute_one("SELECT count(*) FROM v").rows == [(n,)]
    tw.execute_one("SELECT id, label FROM v LIMIT 30")
    z = np.asarray(c.features @ m.w - m.b, np.float64)
    for order, want in (("DESC", np.sort(z)[::-1][:9]),
                        ("ASC", np.sort(z)[:9])):
        rows = tw.execute_one(
            f"SELECT id, margin FROM v ORDER BY margin {order} LIMIT 9").rows
        assert np.allclose([r[1] for r in rows], want), order
    tw.execute_one("SELECT id, label, margin FROM v WHERE id IN (1, 2, 3)")
    pos = int(tf.view.engine.members()[0])
    assert tw.execute_one(f"SELECT id, label FROM v WHERE id = {pos} "
                          f"AND label = 1").rows == [(pos, 1)]
    assert tw.execute_one(f"SELECT id, label FROM v WHERE id = {pos} "
                          f"AND label = -1").rows == []
    res = tw.execute_one("SELECT id, label FROM v WHERE id IN ("
                         + ", ".join(str(i) for i in range(40)) + ") LIMIT 3")
    assert len(res.rows) == 3 and len(res.tiers_used) == 3
    assert_same_frames(tw)


def test_topk_margin_exact_under_pending_lazy_model():
    c = synthetic_corpus("lzk", 400, 16, seed=25)

    def setup(catalog):
        catalog.register_table("t", c.features, truth=c.labels)
        catalog.create_view("v", "t", "svm",
                            {"policy": "lazy", "p": 2, "q": 2,
                             "cost_mode": "modeled"})

    tw = Twin(setup, group_commit=64)
    rf, tf = tw.facades()
    rng = np.random.default_rng(26)
    n = c.features.shape[0]
    widened = False
    for _ in range(4):
        rows = [int(rng.integers(0, n)) for _ in range(20)]
        tw.execute_one("INSERT INTO t (id, label) VALUES " + ", ".join(
            f"({i}, {int(c.labels[i])})" for i in rows))
        tw.execute_one("COMMIT")
        rf.view.engine.reorganize()
        tf.view.engine.reorganize()
        rows = [int(rng.integers(0, n)) for _ in range(20)]
        tw.execute_one("INSERT INTO t (id, label) VALUES " + ", ".join(
            f"({i}, {-int(c.labels[i])})" for i in rows))
        m = rf.view.model
        tw.tol = float(margin_bound(c.features, m.w, m.b).max()) * 4
        got = [r[1] for r in tw.execute_one(
            "SELECT id, margin FROM v ORDER BY margin DESC LIMIT 6").rows]
        _, _, touched = tf.top_margins(0, 6, True)
        widened |= touched > 6
        m = tf.view.model
        z = np.asarray(c.features @ m.w - m.b, np.float64)
        assert np.allclose(got, np.sort(z)[::-1][:6])
    assert widened
    same_hazy_state(rf.view.engine, tf.view.engine)


def test_multiview_errors_and_class_scans_equal_reference():
    k = 3
    mc = multiclass_corpus("pol", 240, 16, k, seed=35)

    def setup(catalog):
        catalog.register_table("t", mc.features, truth=mc.classes,
                               num_classes=k)
        catalog.create_view("v", "t", "svm", {"k": k, "cost_mode": "modeled"})

    tw = Twin(setup)
    rng = np.random.default_rng(36)
    for _ in range(6):
        rows = [int(rng.integers(0, 240)) for _ in range(8)]
        tw.execute_one("INSERT INTO t (id, class) VALUES " + ", ".join(
            f"({i}, {int(mc.classes[i])})" for i in rows))
    pos = tw.execute_one("SELECT id FROM v WHERE class = 1").rows
    neg = tw.execute_one("SELECT id FROM v WHERE class = 1 AND label = -1").rows
    assert len(pos) + len(neg) == 240
    tw.execute_one("SELECT count(*) FROM v WHERE class = 1 AND label = -1")
    tw.execute_one("SELECT id, class FROM v WHERE id IN (1, 2, 3)")
    tw.execute_one("SELECT id, view, label FROM v WHERE id = 4")
    tw.execute_one("SELECT id, margin FROM v WHERE id = 4 AND view = 2")
    tw.raises("SELECT id, label FROM v WHERE id = 1")       # ambiguous view
    tw.raises("SELECT label FROM v WHERE id = 1 AND view = 3")
    tw.execute_one("INSERT INTO t (id, class) VALUES (1, 2), (3, 0)")
    tw.raises("DELETE FROM t WHERE id = 1")    # no retrain on k views
    tw.raises("EXPLAIN DELETE FROM t WHERE id = 1")
    assert len(tw.tex.log.pending["t"]) == 2
    tw.execute_one("COMMIT")
    tw.raises("SELECT label FROM v WHERE id = 1 AND class = 5")
    rf, tf = tw.facades()
    same_multiview_state(rf.mc.engine, tf.mc.engine)


def test_plan_errors():
    _c, tw = _warm(seed=22)
    tw.raises("SELECT label FROM nope WHERE id = 1")
    tw.raises("SELECT label FROM v WHERE id = 99999")
    tw.raises("CREATE CLASSIFICATION VIEW v2 ON t USING MODEL svm "
              "WITH (bogus = 1)")
    tw.raises("CREATE CLASSIFICATION VIEW v ON t USING MODEL svm")
    tw.raises("CREATE TABLE t2 FROM CORPUS nope")
    tw.raises("SELECT count(*) FROM v WHERE id = 1")
    tw.raises("UPDATE MODEL ON nope")
    tw.raises("SHOW COST ON nope")
    with pytest.raises(TD.PlanError):
        tw.tex.execute_one("SELECT label FROM nope WHERE id = 1")
    mc = multiclass_corpus("logi", 240, 16, 3, seed=37)
    for cat in (tw.rcat, tw.tcat):
        cat.register_table("m", mc.features, truth=mc.classes, num_classes=3)
    tw.raises("CREATE CLASSIFICATION VIEW w ON m USING MODEL logistic "
              "WITH (k = 3)")
    tw.raises("CREATE CLASSIFICATION VIEW w ON m USING MODEL svm "
              "WITH (engine = sharded, k = 3, memory_budget = 0.5)")
    tw.raises("CREATE CLASSIFICATION VIEW w ON m USING MODEL svm "
              "WITH (engine = sharded, k = 3, policy = lazy)")
    tw.raises("CREATE CLASSIFICATION VIEW w ON m USING MODEL svm "
              "WITH (engine = hazy, k = 3)")
    tw.raises("CREATE CLASSIFICATION VIEW w ON m USING MODEL svm "
              "WITH (k = 3, prefetch = on)")
    tw.execute_one("CREATE CLASSIFICATION VIEW w ON m USING MODEL svm "
                   "WITH (k = 3, cost_mode = modeled)")
    tw.raises("SELECT id, label FROM w WHERE id = 1")
    assert tw.execute_one("SELECT id, view, label FROM w WHERE id = 1").rows
    assert tw.execute_one("SELECT label FROM w WHERE id = 1 AND view = 2").rows
    assert tw.execute_one("SELECT id, class FROM w WHERE id = 1").rows


def test_prepared_statements_equal_reference():
    c, tw = _warm(seed=44)
    n = c.features.shape[0]
    assert tw.execute_one(
        "PREPARE pt AS SELECT label FROM v WHERE id = ?").rows == [("pt", 1)]
    assert tw.tex.prepared["pt"].plan is None
    tw.execute_one("EXECUTE pt (3)")
    cached = tw.tex.prepared["pt"].plan
    assert cached is not None and cached.kind == "point"
    rng = np.random.default_rng(45)
    for i in rng.integers(0, n, 25):
        got = tw.execute_one(f"EXECUTE pt ({int(i)})").rows
        assert got == tw.execute_one(
            f"SELECT label FROM v WHERE id = {int(i)}").rows, i
    assert tw.tex.prepared["pt"].plan is cached
    j = int(rng.integers(0, n))
    tw.execute_one(f"INSERT INTO t (id, label) VALUES ({j}, {int(c.labels[j])})")
    got = tw.execute_one(f"EXECUTE pt ({j})").rows[0][0]
    assert tw.tex.execute_prepared("pt", [j]).rows == [(got,)]
    assert tw.rex.execute_prepared("pt", [j]).rows == [(got,)]
    tw.raises("EXECUTE pt (1, 2)")
    tw.raises("EXECUTE nope (1)")
    tw.raises(f"EXECUTE pt ({n + 5})")
    tw.raises("SELECT label FROM v WHERE id = ?")
    tw.raises("PREPARE pt AS SELECT label FROM v WHERE id = ?")
    tw.execute_one("PREPARE cnt AS SELECT count(*) FROM v WHERE label = ?")
    tw.execute_one("EXECUTE cnt (1)")
    tw.execute_one("EXECUTE cnt (-1)")
    tw.raises("EXECUTE cnt (2)")
    tw.execute_one("PREPARE upd AS UPDATE t SET label = ? WHERE id = ?")
    tw.execute_one("EXECUTE upd (1, 5)")
    tw.execute_one("COMMIT")
    assert any(r.op == "update" and r.entity_id == 5
               for r in tw.tex.log.history)
    rf, tf = tw.facades()
    same_hazy_state(rf.view.engine, tf.view.engine)
    assert_same_frames(tw)


def test_results_carry_commit_epoch_and_reads_flush_pending():
    c, tw = _warm(seed=44)
    ex = tw.tex
    epoch0 = ex.log.commits
    res = tw.execute_one(f"INSERT INTO t (id, label) VALUES "
                         f"(5, {int(c.labels[5])})")
    assert res.epoch == epoch0 and ex.log.has_pending("t")
    assert tw.execute_one("SELECT label FROM v WHERE id = 5").epoch \
        == epoch0 + 1
    assert not ex.log.has_pending("t")
    r2 = tw.execute_one("SELECT label FROM v WHERE id = 7")
    assert r2.epoch == ex.log.commits == epoch0 + 1
    tw.execute_one("PREPARE e6 AS SELECT label FROM v WHERE id = ?")
    r3 = tw.execute_one("EXECUTE e6 (7)")
    assert r3.epoch == epoch0 + 1 and r3.rows == r2.rows


def test_group_commit_amortizes_rounds():
    c = synthetic_corpus("amort", 300, 16, seed=18)

    def setup(catalog):
        catalog.register_table("t", c.features, truth=c.labels)
        catalog.create_view("v", "t", "svm",
                            {"policy": "eager", "p": 2, "q": 2,
                             "cost_mode": "modeled"})

    tw = Twin(setup, group_commit=16)
    for j in range(32):
        tw.execute_one(f"INSERT INTO t (id, label) VALUES "
                       f"({j}, {int(c.labels[j])})")
    assert tw.tex.log.commits == 2
    assert tw.tcat.view("v").facade.view.engine.stats.rounds == 2


def test_memory_budget_view_tier_counters_reconcile():
    c = synthetic_corpus("stor", 500, 24, seed=47)

    def setup(catalog):
        catalog.register_table("t", c.features, truth=c.labels)
        catalog.create_view("v", "t", "svm",
                            {"policy": "hybrid", "p": 2, "q": 2,
                             "buffer_frac": 0.02, "cost_mode": "modeled",
                             "memory_budget": 0.1, "page_bytes": 1024})

    tw = Twin(setup)
    try:
        rf, tf = tw.facades()
        n = c.features.shape[0]
        rng = np.random.default_rng(48)
        for _ in range(12):
            rows = [int(rng.integers(0, n)) for _ in range(GROUP)]
            tw.execute_one("INSERT INTO t (id, label) VALUES " + ", ".join(
                f"({i}, {int(c.labels[i])})" for i in rows))
        st0 = tf.storage_stats()
        assert st0 == rf.storage_stats()
        assert st0["budget_bytes"] == int(0.1 * c.features.nbytes)
        before, disk0 = dict(tf.tier_hits), tf.disk_touches
        for _ in range(200):
            i = int(rng.integers(0, n))
            tw.execute_one(f"SELECT label FROM v WHERE id = {i}")
        hits = {t: tf.tier_hits[t] - before[t] for t in tf.tier_hits}
        assert hits["map"] == 0 and sum(hits.values()) == 200
        st1 = tf.storage_stats()
        assert st1 == rf.storage_stats() and tf.tier_hits == rf.tier_hits
        assert tf.disk_touches - disk0 == hits["disk"] \
            == st1["misses"] - st0["misses"]
        res = tw.execute_one("EXPLAIN SELECT label FROM v WHERE id = 0")
        assert res.rows[0][1] == "probe(water->buffer->pool->disk)"
        for cat in (tw.rcat, tw.tcat):
            cat.create_view("w", "t", "svm", {"cost_mode": "modeled"})
        by_name = {r[0]: r for r in tw.execute_one("SHOW STORAGE").rows}
        assert by_name["v"][2] == st1["budget_bytes"]
        assert by_name["w"][2] == "in-ram"
        res = tw.execute_one(
            "EXPLAIN ANALYZE SELECT id, label FROM v WHERE id IN (1, 2, 3)")
        assert [r[0] for r in res.rows][-3:] == ["pool", "epoch", "rows"]
        m = tf.view.model
        truth = np.where(c.features @ m.w - m.b >= 0, 1, -1)
        for i in range(0, n, 17):
            assert tw.execute_one(
                f"SELECT label FROM v WHERE id = {i}").rows[0][0] == truth[i]
        same_hazy_state(rf.view.engine, tf.view.engine)
    finally:
        for cat in (tw.rcat, tw.tcat):
            close_catalog(cat)


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


def test_show_and_explain_analyze_equal_reference():
    c, tw = _warm(seed=50)
    tw.execute_one("SHOW TABLES")
    tw.execute_one("SHOW VIEWS")
    tw.execute_one("SHOW SCHEDULE")
    tw.execute_one("SHOW STORAGE")
    tw.execute_one("SHOW COST ON v")
    for sql in ("EXPLAIN ANALYZE SELECT id, label FROM v WHERE id IN (1, 2)",
                "EXPLAIN ANALYZE SELECT count(*) FROM v WHERE label = 1",
                "EXPLAIN ANALYZE INSERT INTO t VALUES (9, 1)",
                "EXPLAIN ANALYZE SELECT id FROM v WHERE label = -1 LIMIT 4"):
        res = tw.execute_one(sql)
        assert res.columns == ("phase", "actual_us", "detail")
    rm = dict(tw.rex.execute_one("SHOW METRICS").rows)
    tm = dict(tw.tex.execute_one("SHOW METRICS").rows)
    assert sorted(tm) == sorted(rm)
    for key in rm:
        if key.startswith(("counters.", "wal.", "view.v.")) or key == "epoch":
            assert tm[key] == rm[key], key


def test_repl_run_script(capsys):
    from repro_torch.rdbms.repl import run_script
    script = """
        CREATE TABLE t FROM CORPUS synthetic WITH (scale = 0.08);
        CREATE CLASSIFICATION VIEW v ON t USING MODEL svm
            WITH (policy = hybrid, cost_mode = modeled);
        INSERT INTO t (id, label) VALUES (0, 1), (1, -1), (2, 1);
        SELECT count(*) FROM v WHERE label = 1;
        SHOW TABLES;
    """
    ex = run_script(script, TD.Executor(device="cpu"))
    out = capsys.readouterr().out
    assert "count" in out and "(1 rows)" in out
    assert "t" in ex.catalog.tables and "v" in ex.catalog.views
    from repro.rdbms.repl import run_script as ref_run_script
    ref_run_script(script)
    ref_out = capsys.readouterr().out
    strip = [ln for ln in out.splitlines() if not ln.startswith("-- ")]
    assert strip == [ln for ln in ref_out.splitlines()
                     if not ln.startswith("-- ")]


# ---------------------------------------------------------------------------
# the WAL: byte-equal files, replay across the packages
# ---------------------------------------------------------------------------

def test_wal_cross_replay_in_both_directions(tmp_path):
    c = synthetic_corpus("replay", 300, 16, seed=14)
    wal = (str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl"))

    def setup(catalog):
        catalog.register_table("t", c.features, truth=c.labels)
        catalog.create_view("v", "t", "svm",
                            {"policy": "lazy", "p": 2, "q": 2,
                             "cost_mode": "modeled"})

    tw = Twin(setup, group_commit=5, wal=wal)
    rng = np.random.default_rng(15)
    n = c.features.shape[0]
    for j in range(37):
        i = int(rng.integers(0, n))
        tw.execute_one(
            f"INSERT INTO t (id, label) VALUES ({i}, {int(c.labels[i])})")
        if j % 11 == 10:
            tw.execute_one("COMMIT")
        if j == 20:
            tw.execute_one(f"UPDATE t SET label = 1 WHERE id = {i}")
    tw.execute_one("COMMIT")
    tw.rex.log.close()
    tw.tex.log.close()
    with open(wal[0], "rb") as a, open(wal[1], "rb") as b:
        assert a.read() == b.read()
    ref_hist = RD.UpdateLog.load(wal[1])          # the port's file
    port_hist = TD.UpdateLog.load(wal[0])         # the reference's file
    assert sum(r.op == "commit" for r in port_hist) == tw.tex.log.commits
    rcat2, tcat2 = RD.Catalog(), TD.Catalog(device="cpu")
    setup(rcat2)
    setup(tcat2)
    rlog = RD.UpdateLog.replay_into(ref_hist, rcat2)
    tlog = TD.UpdateLog.replay_into(port_hist, tcat2)
    assert tlog.commits == rlog.commits == tw.tex.log.commits
    assert [dataclasses.astuple(r) for r in tlog.history] == \
        [dataclasses.astuple(r) for r in rlog.history]
    live_r, live_t = tw.facades()
    for rf, tf in ((live_r, tcat2.view("v").facade),
                   (rcat2.view("v").facade, live_t),
                   (rcat2.view("v").facade, tcat2.view("v").facade)):
        same_hazy_state(rf.view.engine, tf.view.engine)


def test_wal_record_json_is_the_reference_format():
    rec = TD.WalRecord(7, "update", "t", 3, -1.0)
    ref = RD.WalRecord(7, "update", "t", 3, -1.0)
    assert rec.to_json() == ref.to_json()
    assert dataclasses.astuple(TD.WalRecord.from_json(ref.to_json())) == \
        dataclasses.astuple(rec)
