"""Catalog: base entity tables + the DAG of classification views; the
counterpart of `repro.rdbms.catalog`, building the port's engine shells on
one device (`Catalog(device=...)`: None means the GPU).

A *base table* is an entity relation — the (n, d) feature rows plus the
ground-truth labels/classes a corpus carries (used only by examples and
benchmarks; the engines never see them). A *classification view* is a
model-based view registered on a base table: `CREATE CLASSIFICATION VIEW`
builds one of the three engine shells behind an `EngineFacade` —

  engine=hazy       k = 1 `ClassificationView` over `HazyEngine`
  engine=multiview  k one-vs-all views over ONE `MultiViewEngine` (default
                    whenever k > 1)
  engine=sharded    `ShardedMultiViewHazy` (device-resident shared order,
                    the multi-view band kernel; eager only)

`CREATE CLASSIFICATION VIEW child ON parent` where `parent` is itself a
view registers a *derived* view: its feature table is the parent's margin
column (a `(n, 1)` float32 matrix), the edge lives in the catalog
(`ViewDef.upstreams` / `.downstreams` — this module is the only one that
touches those attributes directly; everyone else goes through
`topo_order` / `parents_of` / `children_of`, rule FRS001), and the
freshness scheduler refreshes the DAG in topological order.

WITH-options are parsed by the typed `ViewOptions` / `TableOptions`
schemas (`repro_torch.rdbms.options`) — one spec per option, one coercion per
value type, unknown options raise listing the valid set. `memory_budget`
attaches the real storage tier (§3.5.2/Fig. 8 economics): the base
table's feature rows live in an on-disk `EntityStore` (one memory-mapped
file per table, SHARED by every budgeted view on it) and the view gets
its own `BufferPool` over those pages — values in (0, 1] are a fraction
of the entity table's bytes, values > 1 are bytes. `page_bytes` picks the
page geometry (default 8 KiB). `prefetch = on` attaches a background
`Prefetcher` to the pool. `target_lag` hands the view to the freshness
scheduler (`repro_torch.scheduler`): commits queue in the view's inbox instead
of training synchronously, and the daemon refreshes it before staleness
exceeds the lag.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.facade import (
    DerivedViewFacade, EngineFacade, MultiViewFacade, SingleViewFacade,
    make_sharded_facade)
from repro_torch.core.multiclass import MulticlassView
from repro_torch.core.view import ClassificationView
from repro_torch.device import resolve_device
from repro_torch.obs import MetricsRegistry, clock as obs_clock
from repro_torch.rdbms.ast_nodes import PlanError, SqlError
from repro_torch.rdbms.options import DOWNSTREAM, TableOptions, ViewOptions
from repro_torch.scheduler.state import ViewRuntime

__all__ = ["BaseTable", "Catalog", "PlanError", "SqlError", "ViewDef"]


@dataclasses.dataclass
class BaseTable:
    name: str
    features: np.ndarray                      # (n, d) float32
    truth: Optional[np.ndarray] = None        # ground-truth labels/classes
    num_classes: int = 2                      # 2 = binary (±1 labels)
    # on-disk entity stores, keyed by page_bytes — built lazily on the
    # first memory-budgeted view and SHARED by every pool on this table
    stores: Dict[int, object] = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return self.features.shape[0]

    def entity_store(self, page_bytes: int):
        from repro_torch.storage import EntityStore
        es = self.stores.get(int(page_bytes))
        if es is None:
            es = EntityStore.from_array(self.features, page_bytes=page_bytes)
            self.stores[int(page_bytes)] = es
        return es


@dataclasses.dataclass
class ViewDef:
    name: str
    table: str          # ROOT base table (derived views resolve through)
    model: str
    facade: EngineFacade
    options: ViewOptions
    source: Optional[str] = None   # parent VIEW name (derived views only)
    # DAG edges — only this module reads/writes these attributes (FRS001);
    # other modules use topo_order / parents_of / children_of / subtree_of
    upstreams: List[str] = dataclasses.field(default_factory=list)
    downstreams: List[str] = dataclasses.field(default_factory=list)
    # freshness ledger, mutated only inside repro_torch.scheduler (FRS001)
    runtime: ViewRuntime = dataclasses.field(default_factory=ViewRuntime)


class Catalog:
    def __init__(self, metrics: Optional[MetricsRegistry] = None, *,
                 device=None):
        # every view's engine state lives on this one device (None: the
        # GPU, raising without one; "cpu" runs the plain versions). Base
        # tables stay host numpy; the engines copy their rows over.
        self.device = resolve_device(device)
        self.tables: Dict[str, BaseTable] = {}
        self.views: Dict[str, ViewDef] = {}
        # the catalog owns the process-wide registry: views register their
        # facade collectors here, pools record cold-read latencies into it,
        # and the executor adopts it for gate/WAL/span instruments.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # freshness clock: staleness stamps and lag deadlines read THIS,
        # so tests (and the scheduler determinism suite) can swap in a
        # modeled clock. Measured-cost recording stays on the obs clock.
        self.clock = obs_clock

    # -- base tables ---------------------------------------------------
    def register_table(self, name: str, features: np.ndarray, *,
                       truth: Optional[np.ndarray] = None,
                       num_classes: int = 2) -> BaseTable:
        if name in self.tables:
            raise PlanError(f"table {name!r} already exists")
        t = BaseTable(name, np.ascontiguousarray(features, np.float32),
                      truth=truth, num_classes=int(num_classes))
        self.tables[name] = t
        return t

    def create_table_from_corpus(self, name: str, corpus: str,
                                 options: Optional[dict] = None) -> BaseTable:
        """`CREATE TABLE t FROM CORPUS c` — c is a `repro_torch.data`
        factory."""
        import repro_torch.data as data
        opts = (options if isinstance(options, TableOptions)
                else TableOptions.parse(options))
        if corpus in ("forest_like", "dblife_like", "citeseer_like"):
            c = getattr(data, corpus)(scale=opts.scale)
            return self.register_table(name, c.features, truth=c.labels)
        if corpus == "cora_like":
            c = data.cora_like(scale=opts.scale)
            return self.register_table(name, c.features, truth=c.classes,
                                       num_classes=c.num_classes)
        if corpus == "synthetic":
            c = data.synthetic_corpus("synthetic",
                                      max(256, int(4000 * opts.scale)),
                                      64, seed=opts.seed)
            return self.register_table(name, c.features, truth=c.labels)
        raise PlanError(f"unknown corpus {corpus!r}; have forest_like, "
                        f"dblife_like, citeseer_like, cora_like, synthetic")

    # -- classification views ------------------------------------------
    def create_view(self, name: str, table: str, model: str = "svm",
                    options: Optional[dict] = None) -> ViewDef:
        if name in self.views:
            raise PlanError(f"view {name!r} already exists")
        if model not in ("svm", "logistic"):
            raise PlanError(f"USING MODEL must be svm or logistic, "
                            f"got {model!r}")
        opts = (options if isinstance(options, ViewOptions)
                else ViewOptions.parse(options))
        if table == name or (table in self.views
                             and name in self._ancestors(table)):
            raise PlanError(f"view {name!r} ON {table!r} would create a "
                            f"cycle; classification views form a DAG")
        if table in self.views:
            return self._create_derived(name, table, model, opts)
        if table not in self.tables:
            raise PlanError(f"unknown table {table!r}")
        t = self.tables[table]

        k = opts.k if opts.k is not None else (
            t.num_classes if t.num_classes > 2 else 1)
        engine = opts.engine or ("multiview" if k > 1 else "hazy")
        buffer_frac = (opts.buffer_frac if opts.buffer_frac is not None
                       else (0.01 if opts.policy == "hybrid" else 0.0))

        store = None
        if opts.memory_budget is not None:
            if engine == "sharded":
                raise PlanError("memory_budget requires engine=hazy or "
                                "engine=multiview (the sharded engine keeps "
                                "its scratch table device-resident)")
            mb = float(opts.memory_budget)
            budget = int(mb * t.features.nbytes) if mb <= 1.0 else int(mb)
            from repro_torch.storage import PAGE_BYTES, BufferPool
            store = BufferPool(t.entity_store(opts.page_bytes or PAGE_BYTES),
                               budget, metrics=self.metrics)
            if opts.prefetch:
                from repro_torch.storage import Prefetcher
                Prefetcher(store)       # attaches itself as store.prefetcher
        elif opts.page_bytes is not None:
            raise PlanError("page_bytes only applies with memory_budget")
        elif opts.prefetch:
            raise PlanError("prefetch = on requires memory_budget (the "
                            "readahead worker feeds a buffer pool)")

        if model == "logistic" and engine != "hazy":
            # MulticlassView/ShardedFacade train hinge SVM only; a view
            # silently trained with the wrong loss is worse than an error
            raise PlanError("USING MODEL logistic requires engine=hazy "
                            "(k = 1); the multiview/sharded engines train "
                            "svm only")
        if engine == "hazy":
            if k != 1:
                raise PlanError("engine=hazy is single-view; use "
                                "engine=multiview for k > 1")
            cv = ClassificationView(
                t.features, method=model, policy=opts.policy,
                norm=(opts.p, opts.q), lr=opts.lr, l2=opts.l2,
                alpha=opts.alpha, buffer_frac=buffer_frac,
                cost_mode=opts.cost_mode, touch_ns=opts.touch_ns,
                store=store, device=self.device)
            facade: EngineFacade = SingleViewFacade(cv)
        elif engine == "multiview":
            mc = MulticlassView(
                t.features, k, policy=opts.policy, lr=opts.lr, l2=opts.l2,
                alpha=opts.alpha, p=opts.p, q=opts.q,
                cost_mode=opts.cost_mode, touch_ns=opts.touch_ns,
                buffer_frac=buffer_frac, vectorized=True, store=store,
                device=self.device)
            facade = MultiViewFacade(mc)
        else:                                   # engine == "sharded"
            if opts.policy != "eager":
                raise PlanError("engine=sharded maintains eagerly; "
                                "policy must be eager")
            facade = make_sharded_facade(t.features, k, p=opts.p, q=opts.q,
                                         lr=opts.lr, l2=opts.l2,
                                         alpha=opts.alpha,
                                         cap_frac=opts.cap_frac,
                                         device=self.device)
        return self._register_view(ViewDef(name, table, model, facade, opts))

    def _create_derived(self, name: str, parent_name: str, model: str,
                        opts: ViewOptions) -> ViewDef:
        """`CREATE CLASSIFICATION VIEW child ON parent` — a view whose
        feature table is the parent view's margin column."""
        parent = self.views[parent_name]
        if parent.facade.num_views != 1:
            raise PlanError(
                f"view {parent_name!r} has {parent.facade.num_views} "
                f"one-vs-all views; a derived view consumes a single "
                f"margin column — its parent must be a k = 1 view")
        if opts.k not in (None, 1):
            raise PlanError("derived views are single-view (k = 1): their "
                            "input is the parent's one margin column")
        if opts.engine not in (None, "hazy"):
            raise PlanError("derived views require engine=hazy (k = 1 over "
                            "the parent's margin column)")
        if (opts.memory_budget is not None or opts.page_bytes is not None
                or opts.prefetch):
            raise PlanError("derived views keep their (n, 1) margin column "
                            "in RAM; memory_budget/page_bytes/prefetch "
                            "apply to views ON a base table")
        buffer_frac = (opts.buffer_frac if opts.buffer_frac is not None
                       else (0.01 if opts.policy == "hybrid" else 0.0))
        feats = parent.facade.margins_of(np.arange(parent.facade.n))
        cv = ClassificationView(
            feats, method=model, policy=opts.policy, norm=(opts.p, opts.q),
            lr=opts.lr, l2=opts.l2, alpha=opts.alpha,
            buffer_frac=buffer_frac, cost_mode=opts.cost_mode,
            touch_ns=opts.touch_ns, device=self.device)
        facade = DerivedViewFacade(cv, parent_name)
        vd = ViewDef(name, parent.table, model, facade, opts,
                     source=parent_name, upstreams=[parent_name],
                     runtime=ViewRuntime(
                         upstream_version_seen=parent.runtime.version))
        parent.downstreams.append(name)
        return self._register_view(vd)

    def _register_view(self, vd: ViewDef) -> ViewDef:
        self.views[vd.name] = vd
        self.metrics.register_collector(f"view.{vd.name}",
                                        vd.facade.telemetry_snapshot)
        return vd

    def alter_view_options(self, name: str, options: dict) -> ViewDef:
        """`ALTER VIEW v SET (...)` — typed-schema validated; only options
        marked alterable (today: target_lag) may change post-CREATE."""
        vd = self.view(name)
        vd.options = vd.options.alter(options)
        return vd

    # -- lookups -------------------------------------------------------
    def table(self, name: str) -> BaseTable:
        if name not in self.tables:
            raise PlanError(f"unknown table {name!r}")
        return self.tables[name]

    def view(self, name: str) -> ViewDef:
        if name not in self.views:
            raise PlanError(f"unknown view {name!r}")
        return self.views[name]

    def views_on(self, table: str) -> List[ViewDef]:
        return [v for v in self.views.values() if v.table == table]

    # -- the view DAG (sole owner of the edge attributes — FRS001) -----
    def parents_of(self, name: str) -> List[ViewDef]:
        return [self.views[u] for u in self.view(name).upstreams]

    def children_of(self, name: str) -> List[ViewDef]:
        return [self.views[d] for d in self.view(name).downstreams]

    def _ancestors(self, name: str) -> List[str]:
        out: List[str] = []
        vd = self.views.get(name)
        while vd is not None and vd.source is not None:
            out.append(vd.source)
            vd = self.views.get(vd.source)
        return out

    def topo_order(self) -> List[ViewDef]:
        """Every view, parents before children; deterministic (catalog
        insertion order among independents). THE refresh order — modules
        that need one consume this instead of re-deriving it (FRS001)."""
        out: List[ViewDef] = []
        seen: set = set()

        def visit(vd: ViewDef) -> None:
            if vd.name in seen:
                return
            seen.add(vd.name)
            for u in vd.upstreams:
                visit(self.views[u])
            out.append(vd)

        for vd in self.views.values():
            visit(vd)
        # children can be visited before unrelated roots; re-sort stably
        # by dependency depth to keep parents strictly first
        rank: Dict[str, int] = {}

        def depth(vd: ViewDef) -> int:
            if vd.name not in rank:
                rank[vd.name] = 1 + max(
                    (depth(self.views[u]) for u in vd.upstreams), default=-1)
            return rank[vd.name]

        return sorted(out, key=depth)

    def subtree_of(self, roots: List[ViewDef]) -> List[ViewDef]:
        """`roots` plus every (transitive) derived consumer, topo order."""
        want: set = set()

        def walk(vd: ViewDef) -> None:
            if vd.name in want:
                return
            want.add(vd.name)
            for d in vd.downstreams:
                walk(self.views[d])

        for vd in roots:
            walk(vd)
        return [vd for vd in self.topo_order() if vd.name in want]

    def effective_lag(self, name: str) -> Optional[float]:
        """Resolve a view's freshness target: a declared number of seconds
        stands; `downstream` takes the tightest effective lag among the
        view's consumers; None (or `downstream` with no numeric consumer)
        means the view is maintained at commit time — immediate."""
        vd = self.view(name)
        lag = vd.options.target_lag
        if lag is None:
            return None
        if lag != DOWNSTREAM:
            return float(lag)
        lags = [self.effective_lag(d) for d in vd.downstreams]
        lags = [v for v in lags if v is not None]
        return min(lags) if lags else None

    def deliver_group(self, table: str, group) -> None:
        """One committed WAL group -> the table's view DAG (the scheduler
        package owns delivery semantics; the WAL just hands over)."""
        from repro_torch.scheduler import refresh as _refresh
        _refresh.deliver_group(self, table, group)
