"""Executor: plans -> engine calls; EXPLAIN makes the cost model visible.

Execution contract:

  * DML (INSERT / UPDATE / DELETE) goes through the group-commit WAL —
    statements return immediately with `queued` rows; the engine round
    happens at commit (group full, read on the table, UPDATE MODEL, or
    COMMIT).
  * reads flush the target table's pending group first (read-your-writes),
    then route through the planned tier; the executed `Result` carries the
    plan AND the actually-used tiers, so `EXPLAIN` for a point SELECT
    reports the waters/buffer/band(disk) tier that really answered it.
  * `EXPLAIN <stmt>` never commits and never mutates engine state beyond
    the dry-run probe it reports (for point lookups under hybrid, the
    probe IS the cheapest way to know the tier — it is tier-counted like
    any probe).

Concurrency contract (the SQL server drives one Executor from N session
threads; see `repro_torch.rdbms.concurrency`):

  * every statement runs under the epoch gate. Point SELECTs on eager /
    hybrid views hold it SHARED — they pin the epoch (committed WAL batch
    index) at statement start, proceed concurrently with each other, and
    are guaranteed never to observe a later commit's labels/waters
    mid-statement (the executed `Result.epoch` records the pin, and the
    guard re-checks it at statement end).
  * everything that mutates engine state — DML appends + group commits,
    UPDATE MODEL, DDL, and catch-up-capable reads (scans / counts / top-k
    / any read on a LAZY view) — holds the gate EXCLUSIVELY and advances
    the epoch behind the pinned readers.
  * the read-your-writes flush runs as its own exclusive section BEFORE
    the read takes its shared pin, so a flush can never interleave with
    anyone's pinned snapshot.

`Session` wraps an Executor with a per-session prepared-statement cache —
each SQL-server connection gets one, so PREPARE names are session-scoped
exactly like real wire protocols scope them.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.facade import TIERS
from repro_torch.obs import trace
from repro_torch.obs.trace import Span, render_tree
from repro_torch.rdbms.ast_nodes import (
    AlterView, Commit, CreateTable, CreateView, Delete, ExecutePrepared,
    Explain, Insert, Param, Prepare, Select, Show, SqlError, Statement, Update,
    UpdateModel, Where)
from repro_torch.rdbms.catalog import Catalog, PlanError
from repro_torch.rdbms.concurrency import EpochGate
from repro_torch.rdbms.options import format_lag
from repro_torch.rdbms.parser import parse
from repro_torch.rdbms.planner import Plan, _resolve_view_index, plan_statement
from repro_torch.rdbms.wal import UpdateLog
from repro_torch.scheduler import refresh as freshness

_slow_log = logging.getLogger("repro_torch.obs.slowlog")

# AST class -> lowercase statement kind ("select", "insert", ...), cached so
# the per-statement hot path skips the __name__.lower() allocation.
_KIND_NAMES: dict = {}


@dataclasses.dataclass
class Result:
    columns: Tuple[str, ...]
    rows: List[tuple]
    plan: Optional[Plan] = None
    tiers_used: Optional[List[str]] = None
    epoch: Optional[int] = None     # committed WAL batch index pinned by
                                    # the statement (None: pre-gate paths)
    trace: Optional[Span] = None    # the statement's finished span tree
                                    # (None on nested dispatch)

    def __iter__(self):
        return iter(self.rows)

    def pretty(self) -> str:
        if not self.rows:
            return "(0 rows)"
        widths = [max(len(str(c)), *(len(str(r[j])) for r in self.rows))
                  for j, c in enumerate(self.columns)]
        fmt = "  ".join(f"{{:<{w}}}" for w in widths)
        lines = [fmt.format(*self.columns),
                 fmt.format(*("-" * w for w in widths))]
        lines += [fmt.format(*(str(x) for x in r)) for r in self.rows]
        return "\n".join(lines) + f"\n({len(self.rows)} rows)"


@dataclasses.dataclass
class _Prepared:
    """A PREPAREd template plus its cached route: the first EXECUTE plans
    once; later EXECUTEs bind parameters and go straight to the physical
    operator — point reads skip parse AND plan."""
    stmt: Statement
    n_params: int
    plan: Optional[Plan] = None


def _bind(stmt: Statement, params: Sequence[float]) -> Statement:
    """Substitute positional parameters for the `?` placeholders of a
    prepared template (the template itself is never mutated)."""
    def val(x, as_int=False):
        if isinstance(x, Param):
            v = params[x.index]
            return int(v) if as_int else v
        return x

    if isinstance(stmt, Select):
        w = stmt.where
        if w is not None:
            label = val(w.label, True) if w.label is not None else None
            if label is not None and label not in (1, -1):
                raise SqlError(f"label parameter must be 1 or -1, "
                               f"got {label}")
            w = Where(
                ids=None if w.ids is None else [val(i, True) for i in w.ids],
                label=label,
                cls=val(w.cls, True) if w.cls is not None else None,
                view=val(w.view, True) if w.view is not None else None)
        limit = val(stmt.limit, True) if stmt.limit is not None else None
        return dataclasses.replace(stmt, where=w, limit=limit)
    if isinstance(stmt, Update):
        return dataclasses.replace(stmt, entity_id=val(stmt.entity_id, True),
                                   label=float(val(stmt.label)))
    if isinstance(stmt, Delete):
        return dataclasses.replace(stmt, entity_id=val(stmt.entity_id, True))
    return stmt


class Executor:
    def __init__(self, catalog: Optional[Catalog] = None, *,
                 group_commit: int = 64, wal_path: Optional[str] = None,
                 slow_ms: Optional[float] = None, device=None):
        # `device` only places a catalog built here (None: the GPU); a
        # catalog passed in keeps its own
        self.catalog = (catalog if catalog is not None
                        else Catalog(device=device))
        # ONE registry for the whole stack: owned by the catalog (views and
        # pools already feed it), adopted here for gate/WAL/span instruments.
        self.metrics = self.catalog.metrics
        self.log = UpdateLog(group_size=group_commit, path=wal_path,
                             metrics=self.metrics)
        self.prepared: dict[str, _Prepared] = {}
        self.gate = EpochGate(metrics=self.metrics)
        self.slow_ms = slow_ms              # slow-statement log threshold
        self._tls = threading.local()       # .depth: nested dispatch guard
        self.metrics.register_collector("wal", self.log.telemetry_snapshot)
        # the freshness ledger rides the unified snapshot (`SHOW METRICS`,
        # the wire `metrics` op) under the "schedule" key
        self.metrics.register_collector(
            "schedule", lambda: freshness.schedule_snapshot(self.catalog))
        # hot-path instruments, resolved once
        self._m_statements = self.metrics.counter("statements")
        self._m_errors = self.metrics.counter("statements.errors")
        self._m_stmt_seconds = self.metrics.histogram("statement.seconds")
        self._m_kind: dict = {}             # kind -> statements.<kind> counter

    @property
    def epoch(self) -> int:
        """Committed WAL batch index — the snapshot version readers pin."""
        return self.log.commits

    def metrics_snapshot(self) -> dict:
        """The unified telemetry snapshot (`SHOW METRICS`, the wire
        `metrics` op): registry instruments + per-component collectors,
        stamped with the current epoch."""
        snap = self.metrics.snapshot()
        snap["epoch"] = self.log.commits
        return snap

    # -- entry points --------------------------------------------------
    def execute(self, sql: str, *,
                prepared: Optional[Dict[str, _Prepared]] = None
                ) -> List[Result]:
        ps = trace.start("parse")
        try:
            stmts = parse(sql)
            ps.attrs["statements"] = len(stmts)
        finally:
            trace.finish(ps)
        return [self.execute_statement(s, prepared=prepared,
                                       _parse_span=ps if i == 0 else None)
                for i, s in enumerate(stmts)]

    def execute_one(self, sql: str, *,
                    prepared: Optional[Dict[str, _Prepared]] = None
                    ) -> Result:
        results = self.execute(sql, prepared=prepared)
        if len(results) != 1:
            raise SqlError(f"expected one statement, got {len(results)}")
        return results[0]

    # -- the concurrency wrapper ---------------------------------------
    def execute_statement(self, stmt: Statement, *,
                          prepared: Optional[Dict[str, _Prepared]] = None,
                          _parse_span: Optional[Span] = None) -> Result:
        """Gate + dispatch under a root "statement" span. Point SELECTs on
        eager/hybrid views run under the SHARED gate (epoch-pinned
        snapshot); everything else runs exclusively (see the module doc's
        concurrency contract). The finished span tree rides on
        `Result.trace` — the server's elapsed_us, EXPLAIN ANALYZE and the
        REPL footer all read the same phases from it."""
        prepared = self.prepared if prepared is None else prepared
        depth = getattr(self._tls, "depth", 0)
        if depth:                            # nested dispatch: guard held
            return self._dispatch(stmt, prepared)
        self._tls.depth = 1
        cls = type(stmt)
        kind = _KIND_NAMES.get(cls)
        if kind is None:
            kind = _KIND_NAMES[cls] = cls.__name__.lower()
        root = trace.start("statement", kind=kind)
        if _parse_span is not None:          # adopt execute()'s parse span
            root.children.insert(0, _parse_span)
        ok = True
        try:
            res = self._execute_gated(stmt, prepared)
            res.trace = root
            return res
        except BaseException:
            ok = False
            raise
        finally:
            self._tls.depth = 0
            trace.finish(root)               # also unwinds any span an
            self._record_statement(root, kind, ok)   # exception left open

    def _execute_gated(self, stmt: Statement,
                       prepared: Dict[str, _Prepared]) -> Result:
        table = self._read_target_table(stmt, prepared)
        if self._shared_eligible(stmt, prepared):
            # read-your-writes flush in its OWN exclusive section,
            # before the shared pin
            if table is not None and self.log.has_pending(table):
                gw = trace.start("gate.wait", mode="exclusive")
                with self.gate.write():
                    trace.finish(gw)
                    with trace.span("flush.read_your_writes", table=table):
                        self.log.flush(self.catalog, table)
            gw = trace.start("gate.wait", mode="shared")
            with self.gate.read():
                trace.finish(gw)
                ex_sp = trace.start("execute")
                try:
                    epoch = self.log.commits
                    res = self._dispatch(stmt, prepared)
                    if self.log.commits != epoch:   # must be unreachable
                        raise SqlError(
                            f"snapshot violated: epoch {epoch} -> "
                            f"{self.log.commits} mid-statement")
                finally:
                    trace.finish(ex_sp)
            res.epoch = epoch
            return res
        gw = trace.start("gate.wait", mode="exclusive")
        with self.gate.write():
            trace.finish(gw)
            if table is not None:           # read-your-writes, already
                with trace.span("flush.read_your_writes", table=table):
                    self.log.flush(self.catalog, table)  # exclusive here
            ex_sp = trace.start("execute")
            try:
                res = self._dispatch(stmt, prepared)
                res.epoch = self.log.commits
            finally:
                trace.finish(ex_sp)
        return res

    def _record_statement(self, root: Span, kind: str, ok: bool):
        """Per-statement registry counters + the slow-statement log."""
        self._m_stmt_seconds.observe(root.duration_s)
        self._m_statements.inc()
        ck = self._m_kind.get(kind)
        if ck is None:
            ck = self._m_kind[kind] = self.metrics.counter(f"statements.{kind}")
        ck.inc()
        if not ok:
            self._m_errors.inc()
        if self.slow_ms is not None and root.duration_s * 1e3 >= self.slow_ms:
            _slow_log.warning("slow statement (%.2f ms >= %.2f ms):\n%s",
                              root.duration_s * 1e3, self.slow_ms,
                              render_tree(root))

    def _read_target_table(self, stmt: Statement,
                           prepared: Dict[str, _Prepared]) -> Optional[str]:
        """The base table a SELECT/EXECUTE reads (None for non-reads or
        unresolvable targets — dispatch raises the real error then)."""
        if isinstance(stmt, Explain) and stmt.analyze:
            stmt = stmt.stmt       # EXPLAIN ANALYZE executes the inner read,
                                   # so read-your-writes must flush for it too
        if isinstance(stmt, ExecutePrepared):
            ps = prepared.get(stmt.name)
            if ps is None:
                return None
            stmt = ps.stmt
        if not isinstance(stmt, Select):
            return None
        try:
            return self.catalog.view(stmt.view).table
        except PlanError:
            return None

    def _shared_eligible(self, stmt: Statement,
                         prepared: Dict[str, _Prepared]) -> bool:
        """True iff the statement is a point read that can run under the
        shared gate: a non-COUNT SELECT with an id predicate on an eager
        or hybrid view. Those never catch up (hybrid probes are exact via
        the waters; eager has nothing deferred) — a LAZY view's point read
        relabels its band and must run exclusively."""
        if isinstance(stmt, ExecutePrepared):
            ps = prepared.get(stmt.name)
            if ps is None:
                return False                 # dispatch raises the real error
            stmt = ps.stmt
        if not isinstance(stmt, Select):
            return False
        w = stmt.where
        if stmt.count or w is None or w.ids is None:
            return False
        try:
            return self.catalog.view(stmt.view).facade.policy != "lazy"
        except PlanError:
            return False                     # dispatch raises the real error

    def _dispatch(self, stmt: Statement,
                  prepared: Dict[str, _Prepared]) -> Result:
        if isinstance(stmt, Explain):
            return self._explain(stmt.stmt, prepared, analyze=stmt.analyze)
        if isinstance(stmt, CreateTable):
            t = self.catalog.create_table_from_corpus(
                stmt.name, stmt.corpus, stmt.options)
            return Result(("table", "n", "d"),
                          [(t.name, t.n, t.features.shape[1])])
        if isinstance(stmt, CreateView):
            vd = self.catalog.create_view(stmt.name, stmt.table, stmt.model,
                                          stmt.options)
            f = vd.facade
            return Result(("view", "table", "k", "policy", "engine"),
                          [(vd.name, vd.table, f.num_views, f.policy,
                            type(f).__name__)])
        if isinstance(stmt, Insert):
            self.catalog.table(stmt.table)
            commits = 0
            wa = trace.start("wal.append", rows=len(stmt.rows))
            try:
                for i, y in stmt.rows:
                    commits += self.log.append("insert", stmt.table, i, y,
                                               self.catalog)
            finally:
                trace.finish(wa)
            return Result(("queued", "commits"), [(len(stmt.rows), commits)])
        if isinstance(stmt, Update):
            self.catalog.table(stmt.table)
            commits = self.log.append("update", stmt.table, stmt.entity_id,
                                      stmt.label, self.catalog)
            return Result(("queued", "commits"), [(1, commits)])
        if isinstance(stmt, Delete):
            # reject BEFORE the record enters the WAL: a facade without the
            # footnote-2 retrain would otherwise fail mid-flush, after the
            # pending group was popped (losing the records ordered after it)
            plan_statement(stmt, self.catalog, self.log)
            commits = self.log.append("delete", stmt.table, stmt.entity_id,
                                      0.0, self.catalog)
            return Result(("queued", "commits"), [(1, commits)])
        if isinstance(stmt, UpdateModel):
            vd = self.catalog.view(stmt.view)
            self.log.flush(self.catalog, vd.table)
            vd.facade.force_round()
            return Result(("view", "round"), [(stmt.view, "applied")])
        if isinstance(stmt, AlterView):
            return self._alter_view(stmt)
        if isinstance(stmt, Commit):
            n = self.log.flush(self.catalog)
            return Result(("commits",), [(n,)])
        if isinstance(stmt, Show):
            if stmt.what == "tables":
                return Result(("table", "n", "d"),
                              [(t.name, t.n, t.features.shape[1])
                               for t in self.catalog.tables.values()])
            if stmt.what == "storage":
                return self._show_storage()
            if stmt.what == "metrics":
                return self._show_metrics()
            if stmt.what == "cost":
                return self._show_cost(stmt.view)
            if stmt.what == "schedule":
                return self._show_schedule()
            return self._show_views()
        if isinstance(stmt, Prepare):
            if stmt.name in prepared:
                raise SqlError(f"prepared statement {stmt.name!r} already "
                               f"exists")
            prepared[stmt.name] = _Prepared(stmt.stmt, stmt.n_params)
            return Result(("prepared", "params"),
                          [(stmt.name, stmt.n_params)])
        if isinstance(stmt, ExecutePrepared):
            return self._execute_prepared(stmt, prepared)
        if isinstance(stmt, Select):
            return self._select(stmt)
        raise SqlError(f"cannot execute {type(stmt).__name__}")

    def _alter_view(self, stmt: AlterView) -> Result:
        """ALTER VIEW — lifecycle verbs route to the scheduler package
        (the only module allowed to mutate freshness state, FRS001);
        SET goes through the typed option schema's alter path."""
        vd = self.catalog.view(stmt.view)
        if stmt.action == "suspend":
            with trace.span("view.suspend", view=vd.name):
                freshness.suspend_view(self.catalog, vd)
        elif stmt.action == "resume":
            # catch up EXACTLY once, right here: queued batches replay
            # with their original commit boundaries
            with trace.span("view.resume", view=vd.name):
                freshness.resume_view(self.catalog, vd)
        elif stmt.action == "refresh":
            with trace.span("view.refresh", view=vd.name):
                self.log.flush(self.catalog, vd.table)
                freshness.refresh_view(self.catalog, vd)
        else:                                   # "set"
            vd = self.catalog.alter_view_options(stmt.view, stmt.options)
        return self._freshness_result(vd)

    def refresh_views(self, view: Optional[str] = None) -> List[str]:
        """The wire `refresh` op — a freshness BARRIER: commit all pending
        DML and bring every view (or `view` + its ancestors) up to date in
        topological order, under one exclusive gate slice. Runs outside
        `execute_statement` so a barrier does not perturb the per-
        statement telemetry the serve benchmarks assert on."""
        gw = trace.start("gate.wait", mode="exclusive")
        with self.gate.write():
            trace.finish(gw)
            with trace.span("refresh.barrier", view=view or "*"):
                self.log.flush(self.catalog)
                return freshness.refresh_all(self.catalog, only=view)

    def _freshness_result(self, vd) -> Result:
        row = next(r for r in freshness.schedule_snapshot(self.catalog)
                   if r["view"] == vd.name)
        return Result(
            ("view", "state", "target_lag", "staleness_s", "inbox_rows"),
            [(vd.name, row["state"], format_lag(row["target_lag"]),
              round(row["staleness_s"], 6), row["inbox_rows"])])

    def _show_views(self) -> Result:
        """SHOW VIEWS — the catalog plus each view's freshness face:
        state (immediate/scheduled/suspended), declared + effective lag,
        measured staleness, last refresh."""
        snap = {r["view"]: r for r in
                freshness.schedule_snapshot(self.catalog)}
        cols = ("view", "on", "k", "policy", "state", "target_lag",
                "effective_lag", "staleness_s", "last_refresh_s")
        rows = []
        for v in self.catalog.views.values():
            r = snap[v.name]
            rows.append((v.name, r["on"], v.facade.num_views,
                         v.facade.policy, r["state"],
                         format_lag(r["target_lag"]),
                         format_lag(r["effective_lag"]),
                         round(r["staleness_s"], 6),
                         ("-" if r["last_refresh_age_s"] is None
                          else round(r["last_refresh_age_s"], 6))))
        return Result(cols, rows)

    def _show_schedule(self) -> Result:
        """SHOW SCHEDULE — the scheduler's full ledger: what's queued,
        what it would cost (SKIING-modeled), who goes next (priority)."""
        cols = ("view", "on", "state", "target_lag", "effective_lag",
                "staleness_s", "inbox_batches", "inbox_rows",
                "modeled_cost", "priority", "refreshes", "rows_applied")
        rows = []
        for r in freshness.schedule_snapshot(self.catalog):
            rows.append((r["view"], r["on"], r["state"],
                         format_lag(r["target_lag"]),
                         format_lag(r["effective_lag"]),
                         round(r["staleness_s"], 6), r["inbox_batches"],
                         r["inbox_rows"], int(r["modeled_cost"]),
                         ("-" if r["priority"] is None
                          else round(r["priority"], 4)),
                         r["refreshes"], r["rows_applied"]))
        return Result(cols, rows)

    def _show_storage(self) -> Result:
        """One row per view: the storage tier's residency and counters
        (views without a memory budget report the whole table in RAM)."""
        cols = ("view", "policy", "budget_bytes", "table_bytes",
                "pages_resident", "pages_total", "pinned_pages", "hits",
                "misses", "evictions", "hit_rate", "in_flight", "coalesced",
                "readahead_pages", "readahead_used")
        rows = []
        for v in self.catalog.views.values():
            st = v.facade.storage_stats()
            if st is None:
                n_bytes = self.catalog.table(v.table).features.nbytes
                rows.append((v.name, v.facade.policy, "in-ram", n_bytes,
                             "-", "-", "-", "-", "-", "-", "-",
                             "-", "-", "-", "-"))
            else:
                rows.append((v.name, v.facade.policy, st["budget_bytes"],
                             st["table_bytes"], st["pages_resident"],
                             st["pages_total"], st["pinned_pages"],
                             st["hits"], st["misses"], st["evictions"],
                             f"{st['hit_rate']:.3f}", st["in_flight"],
                             st["coalesced"], st["readahead_pages"],
                             st["readahead_used"]))
        return Result(cols, rows)

    def execute_prepared(self, name: str, params: Sequence[float] = (), *,
                         prepared: Optional[Dict[str, _Prepared]] = None
                         ) -> Result:
        """Programmatic EXECUTE: bind + run a prepared statement without
        any SQL text (the zero-parse path for embedders)."""
        return self.execute_statement(ExecutePrepared(name, list(params)),
                                      prepared=prepared)

    def _execute_prepared(self, ex: ExecutePrepared,
                          prepared: Dict[str, _Prepared]) -> Result:
        ps = prepared.get(ex.name)
        if ps is None:
            raise SqlError(f"unknown prepared statement {ex.name!r}")
        if len(ex.params) != ps.n_params:
            raise SqlError(f"prepared statement {ex.name!r} takes "
                           f"{ps.n_params} parameter(s), got "
                           f"{len(ex.params)}")
        bound = _bind(ps.stmt, ex.params)
        if isinstance(bound, Select) and bound.where is not None \
                and bound.where.ids is not None and not bound.count:
            # the amortized point route: the cached plan — repeated
            # EXECUTEs skip parse AND plan, paying only a cheap id-range
            # guard (read-your-writes was flushed by the gate wrapper)
            vd = self.catalog.view(bound.view)
            f = vd.facade
            if ps.plan is None:
                ps.plan = plan_statement(bound, self.catalog, self.log)
            else:
                for i in bound.where.ids:
                    if not (0 <= i < f.n):
                        raise PlanError(f"id = {i} out of range (n = {f.n})")
            return self._select_point(bound, f, bound.where, ps.plan)
        # _execute_prepared only ever runs from _dispatch, i.e. with the
        # gate already held — dispatch the bound statement directly
        # instead of re-entering execute_statement, so the gate is
        # acquired on exactly one statically-visible path
        return self._dispatch(bound, prepared)

    # -- SELECT --------------------------------------------------------
    def _select(self, sel: Select) -> Result:
        vd = self.catalog.view(sel.view)
        # (read-your-writes flush happens in the gate wrapper, before the
        # shared pin — never here, where it would commit mid-snapshot)
        with trace.span("plan") as pl:
            plan = plan_statement(sel, self.catalog, self.log)
            pl.attrs["tier"] = plan.tier
        f = vd.facade
        w = sel.where or Where()

        if sel.count:
            if w.label is None and w.cls is None:
                # unpredicated COUNT(*): table cardinality, not membership
                return Result(("count",), [(f.n,)], plan=plan)
            v = _resolve_view_index(w, f, None)
            c = int(f.counts()[v])
            if (w.label is not None and w.label == -1):
                c = f.n - c
            return Result(("count",), [(c,)], plan=plan)

        if w.ids is not None:
            return self._select_point(sel, f, w, plan)

        if sel.order_by == "margin":
            v = _resolve_view_index(w, f, sel.columns)
            limit = sel.limit if sel.limit is not None else 10
            ids, margins, touched = f.top_margins(v, limit, sel.descending)
            plan.detail += f";touched={touched}"
            cols = sel.columns or ["id", "margin"]
            if "margin" not in cols:
                cols = cols + ["margin"]
            rows = [self._row(cols, f, int(i), view=v, margin=float(m),
                              label=(1 if m >= 0 else -1))
                    for i, m in zip(ids, margins)]
            return Result(tuple(cols), rows, plan=plan)

        if w.label is not None or w.cls is not None:
            v = _resolve_view_index(w, f, sel.columns)
            # class = c picks the one-vs-all view; a conjoined label = ±1
            # picks the polarity within it (default: the members)
            positive = (w.label != -1)
            # scan route: schedule the prospective band's pages for
            # readahead BEFORE the catch-up relabel iterates it (advisory;
            # no-op without a storage tier + prefetcher)
            f.prefetch_band(v)
            ids = f.members(v, positive=positive)
            if sel.limit is not None:
                ids = ids[:sel.limit]
            cols = sel.columns or ["id", "label"]
            lab = 1 if positive else -1
            rows = [self._row(cols, f, int(i), view=v, label=lab)
                    for i in ids]
            return Result(tuple(cols), rows, plan=plan)

        # bare scan: every entity's label of one view
        v = _resolve_view_index(w, f, sel.columns)
        cols = sel.columns or ["id", "label"]
        f.prefetch_band(v)                   # advisory band readahead
        pos = set(int(x) for x in f.members(v, True))   # catches up the view
        ids = np.arange(f.n)
        if sel.limit is not None:
            ids = ids[:sel.limit]
        rows = [self._row(cols, f, int(i), view=v,
                          label=(1 if int(i) in pos else -1))
                for i in ids]
        return Result(tuple(cols), rows, plan=plan)

    def _select_point(self, sel: Select, f, w: Where, plan: Plan) -> Result:
        cols = sel.columns or ["id", "label"]
        all_views = f.num_views > 1 and w.view is None and "view" in cols
        if w.label is not None and "class" in cols:
            raise PlanError("a label predicate cannot be combined with the "
                            "class column on a point lookup")
        # each id yields >= 1 row, so never probe more ids than LIMIT rows
        ids = w.ids if sel.limit is None else w.ids[:max(1, sel.limit)]
        rows: List[tuple] = []
        tiers: List[str] = []
        pr = trace.start("probe", ids=len(ids))
        try:
            for i in ids:
                if "class" in cols:
                    cls = f.predict(int(i))
                    rows.append(self._row(cols, f, int(i), cls=cls))
                    tiers.append("probe" if f.policy == "hybrid" else "map")
                elif "margin" in cols:
                    v = _resolve_view_index(w, f, cols)
                    z = f.margin(int(i), v)
                    if w.label is not None \
                            and (1 if z >= 0 else -1) != w.label:
                        continue       # conjoined label predicate filters
                    rows.append(self._row(cols, f, int(i), view=v,
                                          label=(1 if z >= 0 else -1),
                                          margin=z))
                    tiers.append("disk")
                elif all_views:
                    labels, hows = f.point_labels_of(int(i))
                    tiers.extend(hows)
                    for v in range(f.num_views):
                        if w.label is not None and int(labels[v]) != w.label:
                            continue
                        rows.append(self._row(cols, f, int(i), view=v,
                                              label=int(labels[v])))
                else:
                    v = _resolve_view_index(w, f, cols)
                    lab, how = f.point_label(int(i), v)
                    tiers.append(how)
                    if w.label is not None and lab != w.label:
                        continue       # conjoined label predicate filters
                    rows.append(self._row(cols, f, int(i), view=v, label=lab))
            pr.attrs["tiers"] = ",".join(tiers)
        finally:
            trace.finish(pr)
        if sel.limit is not None:
            rows = rows[:sel.limit]
        return Result(tuple(cols), rows, plan=plan, tiers_used=tiers)

    @staticmethod
    def _row(cols: Sequence[str], f, entity_id: int, *, view: int = 0,
             label: Optional[int] = None, margin: Optional[float] = None,
             cls: Optional[int] = None) -> tuple:
        out = []
        for c in cols:
            if c == "id":
                out.append(entity_id)
            elif c == "view":
                out.append(view)
            elif c == "label":
                out.append(label if label is not None
                           else f.label(entity_id, view))
            elif c == "margin":
                out.append(margin if margin is not None
                           else f.margin(entity_id, view))
            elif c == "class":
                out.append(cls if cls is not None else f.predict(entity_id))
            else:
                raise PlanError(f"unknown column {c!r}")
        return tuple(out)

    # -- EXPLAIN -------------------------------------------------------
    def _explain(self, stmt: Statement, prepared: Dict[str, _Prepared],
                 analyze: bool = False) -> Result:
        with trace.span("plan"):
            plan = plan_statement(stmt, self.catalog, self.log)
        if analyze:
            return self._explain_analyze(stmt, prepared, plan)
        cols = ("step", "tier", "est_touched_tuples", "detail")
        rows = [plan.row()]
        if isinstance(stmt, Select) and stmt.where is not None \
                and stmt.where.ids is not None and not stmt.count \
                and "margin" not in stmt.columns \
                and "class" not in stmt.columns \
                and self.catalog.view(stmt.view).facade.policy == "hybrid":
            # dry-run the probe: for a point SELECT the actual §3.5.2 tier
            # is cheapest to *measure* (one eps-map probe), and that is
            # what the acceptance contract asks EXPLAIN to report.
            vd = self.catalog.view(stmt.view)
            f = vd.facade
            used = []
            w = stmt.where
            all_views = f.num_views > 1 and w.view is None \
                and "view" in stmt.columns
            for i in w.ids:
                if 0 <= i < f.n:
                    if all_views:
                        _, hows = f.point_labels_of(int(i))
                        used.extend(hows)
                    else:
                        v = _resolve_view_index(w, f, stmt.columns)
                        _, how = f.point_label(int(i), v)
                        used.append(how)
            rows.append(("probe(actual)", "/".join(used),
                         sum(h == "disk" for h in used),
                         "tiers actually used by the dry-run probe"))
        return Result(cols, rows, plan=plan)

    def _explain_analyze(self, stmt: Statement,
                         prepared: Dict[str, _Prepared],
                         plan: Plan) -> Result:
        """EXPLAIN ANALYZE: EXECUTE the inner statement (Postgres
        semantics — DML commits!) and annotate the plan with the measured
        span tree plus the EXACT per-tier counter deltas it caused. The
        tier row is computed from the facade's `tier_hits` (and the pool's
        counters) sampled before/after, so it reconciles with the registry
        by construction."""
        target = stmt
        if isinstance(target, ExecutePrepared):
            ps = prepared.get(target.name)
            if ps is not None:
                target = ps.stmt
        f = None
        if isinstance(target, Select):
            try:
                f = self.catalog.view(target.view).facade
            except PlanError:
                f = None               # dispatch raises the real error
        tiers0 = dict(f.tier_hits) if f is not None else None
        st0 = f.storage_stats() if f is not None else None
        sp = trace.start("analyze")
        try:
            inner = self._dispatch(stmt, prepared)
        finally:
            trace.finish(sp)
        cols = ("phase", "actual_us", "detail")
        rows: List[tuple] = [("plan", "-", ";".join(
            str(x) for x in plan.row()))]
        def emit(s: Span, depth: int):
            attrs = ";".join(f"{k}={v}" for k, v in s.attrs.items())
            rows.append(("  " * depth + s.name, f"{s.duration_us:.1f}",
                         attrs))
            for c in s.children:
                emit(c, depth + 1)

        emit(sp, 0)
        if tiers0 is not None:
            delta = {t: f.tier_hits[t] - tiers0.get(t, 0) for t in TIERS}
            rows.append(("tiers", "-",
                         ";".join(f"{t}={delta[t]}" for t in TIERS)))
        st1 = f.storage_stats() if f is not None else None
        if st0 is not None and st1 is not None:
            rows.append(("pool", "-",
                         f"hits={st1['hits'] - st0['hits']};"
                         f"misses={st1['misses'] - st0['misses']};"
                         f"coalesced={st1['coalesced'] - st0['coalesced']}"))
        rows.append(("epoch", "-", str(self.log.commits)))
        rows.append(("rows", "-", str(len(inner.rows))))
        return Result(cols, rows, plan=plan, tiers_used=inner.tiers_used)

    # -- SHOW METRICS / SHOW COST --------------------------------------
    def _show_metrics(self) -> Result:
        """The registry snapshot flattened to sorted dotted keys (nested
        collector dicts included; list-valued entries — e.g. per-view cost
        rows, histogram bucket arrays — are summarized, not exploded)."""
        flat: Dict[str, object] = {}

        def add(prefix: str, obj):
            if isinstance(obj, dict):
                for k in obj:
                    add(f"{prefix}.{k}" if prefix else str(k), obj[k])
            elif isinstance(obj, (list, tuple)):
                flat[prefix] = f"<{len(obj)} entries>"
            elif isinstance(obj, float):
                flat[prefix] = f"{obj:.6g}"
            else:
                flat[prefix] = obj

        add("", self.metrics_snapshot())
        return Result(("metric", "value"),
                      [(k, flat[k]) for k in sorted(flat)])

    def _show_cost(self, name: Optional[str]) -> Result:
        """SHOW COST ON <view>: per-view modeled-vs-measured SKIING rows —
        the modeled S / accumulated charges next to the wall-clock
        reorganize and step timings the engine recorded alongside them."""
        vd = self.catalog.view(name)
        stats = vd.facade.cost_stats()
        if stats is None:
            raise SqlError(f"view {name!r} records no cost telemetry "
                           f"(engine=sharded keeps its state on-device)")
        cols = ("view", "v", "policy", "cost_mode", "S_model",
                "S_measured_mean_s", "reorgs", "steps", "charge_modeled",
                "seconds_measured", "seconds_per_charge", "acc",
                "lazy_waste")

        def fmt(x):
            if x is None:
                return "-"
            if isinstance(x, float):
                return f"{x:.6g}"
            return x

        rows = [(name, r["view"], r["policy"], r["cost_mode"],
                 fmt(r["S_model"]), fmt(r["S_measured_mean_s"]),
                 r["reorgs_modeled"], r["steps_measured"],
                 fmt(r["charge_modeled"]), fmt(r["seconds_measured"]),
                 fmt(r["seconds_per_charge"]), fmt(r["acc"]),
                 fmt(r.get("lazy_waste")))
                for r in stats]
        return Result(cols, rows)


class Session:
    """One client's view of a shared Executor: a private prepared-statement
    cache (PREPARE names are session-scoped, like every real wire
    protocol) over the shared catalog/WAL/engines. The SQL server opens
    one per connection; N sessions drive one Executor concurrently and the
    epoch gate arbitrates."""

    _ids = itertools.count(1)

    def __init__(self, executor: Executor):
        self.executor = executor
        self.session_id = next(Session._ids)
        self.prepared: Dict[str, _Prepared] = {}
        self.statements = 0

    def execute(self, sql: str) -> List[Result]:
        self.statements += 1
        return self.executor.execute(sql, prepared=self.prepared)

    def execute_one(self, sql: str) -> Result:
        self.statements += 1
        return self.executor.execute_one(sql, prepared=self.prepared)

    def execute_prepared(self, name: str,
                         params: Sequence[float] = ()) -> Result:
        self.statements += 1
        return self.executor.execute_prepared(name, params,
                                              prepared=self.prepared)
