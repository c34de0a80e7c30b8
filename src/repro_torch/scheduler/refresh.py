"""Refresh mechanics: commit delivery, inbox consumption, feature pulls.

This module is the ONLY place freshness state (`ViewRuntime`) is mutated
and the only consumer of the catalog's DAG accessors (`topo_order`,
`children_of`, `parents_of`) — the FRS001 analysis rule keeps it that
way. Every function here runs under the executor's exclusive epoch gate:
either the calling statement already holds it (WAL flush, ALTER VIEW) or
the scheduler daemon takes it for the slice (`FreshnessScheduler.tick`).

Delivery protocol (what makes lagged == immediate at the same commit
boundaries):

  * a WAL commit delivers the group to each ROOT view of the table, in
    catalog order. An *immediate* view (no effective lag, not suspended)
    consumes the batch right there — exactly the pre-scheduler behavior;
    a *scheduled* view queues it in its inbox, preserving batch
    boundaries, so a later refresh replays the identical engine rounds.
  * when a view consumes a batch it emits an enriched batch to each
    consumer view: the SAME (ids, labels), plus input features pinned at
    emission time — the parent's post-batch margins over the batch's own
    pinned inputs. SGD is per-example sequential, so a derived view that
    trains on those pinned features reaches the same model whether it
    refreshes now or seconds later.
  * a refresh drains ancestors first (in topological order), consumes the
    inbox batch-by-batch, and — for derived views — re-pulls the full
    feature table from the parent's current margins (`refresh_features`,
    skipped when the parent's version hasn't moved).

`target_lag = 'downstream'` resolves through the catalog
(`Catalog.effective_lag`): the minimum of the consumers' effective lags;
unresolvable (no consumer declares a numeric lag) means the view is
maintained on demand only — i.e. it behaves as immediate.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.obs import clock
from repro_torch.rdbms.ast_nodes import SqlError
from repro_torch.scheduler.state import Batch


def is_scheduled(catalog, vd) -> bool:
    """Scheduler-managed: suspended, or declares a resolvable lag."""
    return vd.runtime.suspended or catalog.effective_lag(vd.name) is not None


def upstream_blocked(catalog, vd) -> bool:
    """True when a suspended ancestor is holding back committed data —
    refreshing `vd` could not make it fresh w.r.t. the base table."""
    for parent in catalog.parents_of(vd.name):
        if parent.runtime.suspended and (
                parent.runtime.inbox or parent.runtime.stale_since is not None):
            return True
        if upstream_blocked(catalog, parent):
            return True
    return False


# ---------------------------------------------------------------------------
# commit delivery (called from the WAL flush, commit lock + gate held)
# ---------------------------------------------------------------------------

def deliver_group(catalog, table: str, group) -> None:
    """Deliver one committed WAL group to the table's view DAG. Root views
    are fed in catalog order (immediate views consume synchronously, so
    behavior without lags is byte-identical to the pre-scheduler feed);
    every scheduled view in the subtree is stamped stale NOW — staleness
    is measured against the base-table commit, not against whenever an
    upstream view got around to emitting."""
    roots = [vd for vd in catalog.views_on(table) if vd.source is None]
    if not roots:
        return
    now = catalog.clock()
    for vd in catalog.subtree_of(roots):
        if is_scheduled(catalog, vd) and vd.runtime.stale_since is None:
            vd.runtime.stale_since = now

    pending: List = []

    def feed(batch_records):
        if not batch_records:
            return
        ids = [r.entity_id for r in batch_records]
        ys = [r.label for r in batch_records]
        for vd in roots:
            _offer(catalog, vd, Batch(list(ids), list(ys)), now)

    for rec in group:
        if rec.op == "delete":
            feed(pending)
            pending = []
            blocked = [v.name for v in catalog.subtree_of(roots)
                       if v.source is not None or is_scheduled(catalog, v)]
            if blocked:
                raise SqlError(
                    f"DELETE on {table!r} requires every view on it to be "
                    f"immediate (footnote-2 retrain cannot replay through "
                    f"inboxes/derived views); offending: {sorted(blocked)}")
            for vd in roots:
                vd.facade.delete_examples(rec.entity_id)
        else:
            pending.append(rec)
    feed(pending)


def _offer(catalog, vd, batch: Batch, now: float) -> None:
    """One committed batch arrives at `vd`: queue it (scheduled) or
    consume it on the spot (immediate)."""
    if is_scheduled(catalog, vd):
        vd.runtime.inbox.append(batch)
        if vd.runtime.stale_since is None:
            vd.runtime.stale_since = now
        return
    _consume_batch(catalog, vd, batch, now)


def _consume_batch(catalog, vd, batch: Batch, now: float) -> None:
    """Apply ONE batch as one engine round, then emit the enriched batch
    (features pinned from the post-batch model) to each consumer."""
    if batch.features is not None:
        vd.facade.insert_examples(batch.ids, batch.labels,
                                  features=batch.features)
    else:
        vd.facade.insert_examples(batch.ids, batch.labels)
    vd.runtime.batches_applied += 1
    vd.runtime.rows_applied += len(batch)
    vd.runtime.version += 1
    children = catalog.children_of(vd.name)
    if not children:
        return
    feats = vd.facade.margins_of(batch.ids, rows=batch.features)
    for child in children:
        _offer(catalog, child,
               Batch(list(batch.ids), list(batch.labels), feats), now)


# ---------------------------------------------------------------------------
# refresh (gate held exclusively by the caller)
# ---------------------------------------------------------------------------

def refresh_view(catalog, vd, now: Optional[float] = None,
                 _seen: Optional[set] = None) -> List[str]:
    """Bring `vd` up to date: drain ancestors first (topological order),
    consume the inbox batch-by-batch, re-pull derived features if the
    parent moved. Returns the names refreshed, ancestors first. Suspended
    views are left frozen (RESUME is their only way forward)."""
    now = catalog.clock() if now is None else now
    if _seen is None:
        _seen = set()
    out: List[str] = []
    if vd.name in _seen:
        return out
    _seen.add(vd.name)
    for parent in catalog.parents_of(vd.name):
        out.extend(refresh_view(catalog, parent, now, _seen))
    if vd.runtime.suspended:
        return out
    t0 = clock()
    modeled = modeled_catchup_cost(catalog, vd)
    inbox, vd.runtime.inbox = vd.runtime.inbox, []
    for batch in inbox:
        _consume_batch(catalog, vd, batch, now)
    if vd.source is not None:
        parent = catalog.view(vd.source)
        if parent.runtime.version != vd.runtime.upstream_version_seen:
            feats = parent.facade.margins_of(np.arange(parent.facade.n))
            vd.facade.refresh_features(feats)
            vd.runtime.upstream_version_seen = parent.runtime.version
            vd.runtime.version += 1
    if not upstream_blocked(catalog, vd):
        vd.runtime.stale_since = None
    vd.runtime.last_refresh_at = now
    vd.runtime.refreshes += 1
    # measured wall clock recorded ALONGSIDE the modeled charge — the
    # scheduler never reads it back (SHOW SCHEDULE / SHOW COST do); on a
    # GPU the clock stops only once the refresh's device work is done
    if catalog.device.type == "cuda":
        torch.cuda.synchronize(catalog.device)
    vd.runtime.cost.record_step(0, clock() - t0, modeled)
    out.append(vd.name)
    return out


def refresh_all(catalog, now: Optional[float] = None,
                only: Optional[str] = None) -> List[str]:
    """The refresh barrier: every view (or `only` + its ancestors) brought
    up to date in topological order. The wire `refresh` op and `ALTER
    VIEW ... REFRESH` land here."""
    now = catalog.clock() if now is None else now
    if only is not None:
        return refresh_view(catalog, catalog.view(only), now)
    seen: set = set()
    out: List[str] = []
    for vd in catalog.topo_order():
        out.extend(refresh_view(catalog, vd, now, seen))
    return out


def suspend_view(catalog, vd) -> None:
    """Freeze the view: reads keep serving the current labels; committed
    updates queue in the inbox (and in upstream emissions)."""
    vd.runtime.suspended = True


def resume_view(catalog, vd, now: Optional[float] = None) -> List[str]:
    """Unfreeze and catch up EXACTLY once: the queued batches replay with
    their original commit boundaries, so the round-trip is bit-identical
    to never having suspended."""
    vd.runtime.suspended = False
    return refresh_view(catalog, vd, now)


# ---------------------------------------------------------------------------
# cost + priority (what the daemon schedules on; SHOW SCHEDULE renders it)
# ---------------------------------------------------------------------------

def modeled_catchup_cost(catalog, vd) -> float:
    """SKIING-modeled cost of refreshing `vd` now, in touched-tuple units:
    queued training rows + the prospective band a maintenance round
    relabels + a full feature pull if the parent moved. Modeled only —
    measured wall clock is recorded alongside, never consulted."""
    cost = float(vd.runtime.inbox_rows())
    band, _, _ = vd.facade.band_info(0)
    cost += float(band)
    if vd.source is not None:
        parent = catalog.view(vd.source)
        if parent.runtime.version != vd.runtime.upstream_version_seen:
            cost += float(vd.facade.n)
    return cost


def priority(catalog, vd, now: float) -> Optional[float]:
    """(staleness / lag) damped by normalized modeled catch-up cost —
    None for views the scheduler doesn't manage."""
    lag = catalog.effective_lag(vd.name)
    if lag is None:
        return None
    urgency = vd.runtime.staleness(now) / lag
    cost_norm = modeled_catchup_cost(catalog, vd) / max(1, vd.facade.n)
    return urgency / (1.0 + cost_norm)


def schedule_snapshot(catalog, now: Optional[float] = None) -> List[dict]:
    """One row per view: the freshness ledger `SHOW SCHEDULE` renders and
    the metrics registry collects."""
    now = catalog.clock() if now is None else now
    rows = []
    for vd in catalog.topo_order():
        rt = vd.runtime
        lag = catalog.effective_lag(vd.name)
        state = ("suspended" if rt.suspended
                 else "scheduled" if lag is not None else "immediate")
        pr = priority(catalog, vd, now)
        rows.append({
            "view": vd.name,
            "on": vd.source if vd.source is not None else vd.table,
            "state": state,
            "target_lag": vd.options.target_lag,
            "effective_lag": lag,
            "staleness_s": rt.staleness(now),
            "inbox_batches": len(rt.inbox),
            "inbox_rows": rt.inbox_rows(),
            "modeled_cost": modeled_catchup_cost(catalog, vd),
            "priority": pr,
            "refreshes": rt.refreshes,
            "rows_applied": rt.rows_applied,
            "last_refresh_age_s": (None if rt.last_refresh_at is None
                                   else max(0.0, now - rt.last_refresh_at)),
        })
    return rows
