"""Planner: statement AST -> a priced `Plan` routed to a §3.5 tier.

The paper's §3.4/§3.5 argument is that the *right* physical operator for a
classification-view read depends on what the waters already guarantee:

  * point lookups (`WHERE id = ?`) route to the §3.5.2 probe — eps-map +
    waters short-circuit + hot buffer; the feature table is touched only
    on probe misses, so the estimated touched-tuple count is
    #ids × band/n (the probe miss probability);
  * label/class membership scans route to the Lemma 3.1 band partition —
    the certainly-positive suffix is served straight from the clustered
    labels and ONLY the band rows ever need feature access, never full F
    when the waters suffice;
  * COUNT(*) with a label/class predicate is a counter read
    (`pos_count`) — zero tuples touched;
  * top-k margin queries route to the entity-margin step: stored eps
    bound the current margin (Eq. 2), so only `limit + slack` candidate
    rows are recomputed;
  * DML routes through the group-commit WAL: per commit, ONE engine round
    whose touched tuples are the union band.

`plan_statement` is pure — it reads facade state (band widths, pending
masks) but never mutates it, so EXPLAIN costs nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.rdbms.ast_nodes import (
    AlterView, Commit, CreateTable, CreateView, Delete, ExecutePrepared,
    Explain, Insert, Prepare, Select, Show, Update, UpdateModel, Where)
from repro_torch.rdbms.catalog import Catalog, PlanError


@dataclasses.dataclass
class Plan:
    kind: str           # point | scan | count | topk | full | group-commit | ddl | ...
    tier: str           # physical tier the executor will use
    est_touched: int    # §3.4/§3.5 cost model: feature tuples touched
    detail: str = ""
    view: Optional[str] = None

    def row(self):
        return (self.kind, self.tier, self.est_touched, self.detail)


def _resolve_view_index(where: Optional[Where], facade, columns) -> int:
    """Which one-vs-all view a label read addresses. k = 1 -> view 0;
    k > 1 needs `view = j` / `class = c` unless all views are read."""
    w = where or Where()
    if w.view is not None:
        if not (0 <= w.view < facade.num_views):
            raise PlanError(f"view = {w.view} out of range "
                            f"(k = {facade.num_views})")
        return w.view
    if w.cls is not None:
        if not (0 <= w.cls < facade.num_views):
            raise PlanError(f"class = {w.cls} out of range "
                            f"(k = {facade.num_views})")
        return w.cls
    return 0


def plan_select(sel: Select, catalog: Catalog) -> Plan:
    vd = catalog.view(sel.view)
    f = vd.facade
    w = sel.where or Where()
    k = f.num_views
    multi = k > 1

    if sel.count:
        if w.ids is not None:
            raise PlanError("COUNT(*) with id predicate is unsupported")
        if w.label is None and w.cls is None:
            # unpredicated COUNT(*): the base table's cardinality, known
            # without touching any view state
            return Plan("count", "table-cardinality", 0, f"n={f.n}",
                        view=sel.view)
        band, certain_pos, n = f.band_info(_resolve_view_index(w, f, None))
        pend = bool(f.pending()[_resolve_view_index(w, f, None)])
        # a pending lazy view must catch up before the counter is exact
        return Plan("count", "counter(pos_count)"
                    + ("+catch-up" if pend else ""),
                    band if pend else 0, f"certain_pos={certain_pos}",
                    view=sel.view)

    if w.ids is not None:                       # point lookup(s)
        # LIMIT caps the probes the executor will actually issue
        n_ids = len(w.ids) if sel.limit is None \
            else min(len(w.ids), max(1, sel.limit))
        for i in w.ids:
            if not (0 <= i < f.n):
                raise PlanError(f"id = {i} out of range (n = {f.n})")
        if multi and w.view is None and "view" not in sel.columns \
                and "class" not in sel.columns and "margin" not in sel.columns:
            raise PlanError(
                f"view {sel.view!r} has k = {k} one-vs-all views: add "
                f"`view = j` to the WHERE clause, select the `view` "
                f"column (all views), or select `class`")
        v = _resolve_view_index(w, f, sel.columns)
        band, _, n = f.band_info(v)
        if "margin" in sel.columns:
            # margins always recompute from the feature row
            return Plan("point", "margin(feature-row)", n_ids,
                        f"ids={n_ids}", view=sel.view)
        if f.policy == "hybrid":
            # probe miss probability = band fraction; misses touch the
            # storage tier once (a budgeted buffer pool when the view has
            # one — resident page = pool hit, else a cold disk page read)
            est = max(0 if band == 0 else 1,
                      round(n_ids * band / max(1, n)))
            tier = ("probe(water->buffer->pool->disk)"
                    if f.storage_stats() is not None
                    else "probe(water->buffer->disk)")
            return Plan("point", tier, est,
                        f"ids={n_ids};band={band};n={n}", view=sel.view)
        pend = bool(f.pending()[v])
        return Plan("point", "eps-map" + ("+catch-up" if pend else ""),
                    band if pend else 0, f"ids={n_ids}", view=sel.view)

    if sel.order_by == "margin":                # top-k margin
        limit = sel.limit if sel.limit is not None else 10
        v = _resolve_view_index(w, f, sel.columns)
        band, _, n = f.band_info(v)
        est = min(n, limit + band)              # Eq. 2 candidate slack
        return Plan("topk", "eps-order+margin-recompute", est,
                    f"limit={limit};slack<=band={band}", view=sel.view)

    if w.label is not None or w.cls is not None:    # membership scan
        v = _resolve_view_index(w, f, sel.columns)
        band, certain_pos, n = f.band_info(v)
        return Plan("scan", "band-partition", band,
                    f"certain_pos={certain_pos};band={band};n={n}",
                    view=sel.view)

    # bare SELECT id, label FROM v: serve every label from the clustered
    # scratch table; only a pending band would need feature rows
    v = _resolve_view_index(w, f, sel.columns)
    band, _, n = f.band_info(v)
    pend = bool(f.pending()[v])
    return Plan("full", "clustered-labels" + ("+catch-up" if pend else ""),
                band if pend else 0, f"n={n}", view=sel.view)


def plan_statement(stmt, catalog: Catalog, log=None) -> Plan:
    if isinstance(stmt, Select):
        return plan_select(stmt, catalog)
    if isinstance(stmt, Insert):
        views = catalog.views_on(stmt.table)
        catalog.table(stmt.table)
        est = 0
        for vd in views:
            band, _, _ = vd.facade.band_info(0)
            est += band                       # one union-band round/commit
        group = log.group_size if log is not None else 1
        return Plan("group-commit", "wal(batched insert_examples)", est,
                    f"rows={len(stmt.rows)};group_size={group};"
                    f"views={len(views)}")
    if isinstance(stmt, Update):
        catalog.table(stmt.table)
        return Plan("group-commit", "wal(online relabel example)",
                    sum(vd.facade.band_info(0)[0]
                        for vd in catalog.views_on(stmt.table)),
                    f"id={stmt.entity_id}")
    if isinstance(stmt, Delete):
        t = catalog.table(stmt.table)
        unsupported = [vd.name for vd in catalog.views_on(stmt.table)
                       if not vd.facade.supports_delete]
        if unsupported:
            raise PlanError(
                f"DELETE retrains from scratch (paper footnote 2) and is "
                f"only supported by single-view views; views "
                f"{unsupported} on table {stmt.table!r} cannot")
        return Plan("retrain", "full-retrain (footnote 2)", t.n,
                    f"id={stmt.entity_id}")
    if isinstance(stmt, UpdateModel):
        vd = catalog.view(stmt.view)
        band, _, _ = vd.facade.band_info(0)
        return Plan("model-round", "flush+apply_model", band,
                    view=stmt.view)
    if isinstance(stmt, Commit):
        pending = sum(len(v) for v in log.pending.values()) if log else 0
        return Plan("commit", "wal-flush", 0, f"pending={pending}")
    if isinstance(stmt, CreateTable):
        return Plan("ddl", "create-table", 0, stmt.corpus)
    if isinstance(stmt, CreateView):
        if stmt.table in catalog.views:          # derived: ON another view
            parent = catalog.view(stmt.table)
            return Plan("ddl", "create-view(derived, margin-column pull)",
                        parent.facade.n,
                        f"{stmt.options.get('policy', 'eager')};"
                        f"on={stmt.table}")
        t = catalog.table(stmt.table)
        return Plan("ddl", "create-view(initial clustering)", t.n,
                    stmt.options.get("policy", "eager"))
    if isinstance(stmt, AlterView):
        vd = catalog.view(stmt.view)
        if stmt.action == "refresh":
            # catch-up: queued rows + the band a round relabels (SKIING
            # units, same as the scheduler's modeled cost)
            from repro_torch.scheduler import refresh as _refresh
            est = int(_refresh.modeled_catchup_cost(catalog, vd))
            return Plan("refresh", "scheduler(topo catch-up)", est,
                        view=stmt.view)
        return Plan("ddl", f"alter-view({stmt.action})", 0,
                    ",".join(sorted(stmt.options)) or stmt.action,
                    view=stmt.view)
    if isinstance(stmt, Show):
        return Plan("show", "catalog", 0, stmt.what)
    if isinstance(stmt, Prepare):
        # the template may hold ? placeholders — planning happens at the
        # first EXECUTE, and the route is cached from then on
        return Plan("prepare", "statement-cache", 0,
                    f"{stmt.name};params={stmt.n_params}")
    if isinstance(stmt, ExecutePrepared):
        return Plan("execute", "prepared(cached-route)", 0, stmt.name)
    if isinstance(stmt, Explain):
        return plan_statement(stmt.stmt, catalog, log)
    raise PlanError(f"cannot plan {type(stmt).__name__}")
