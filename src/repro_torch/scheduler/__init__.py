"""Freshness scheduler: maintain classification views to a `target_lag`;
the counterpart of `repro.scheduler`.

The paper's lazy/hybrid policies (§3.4–3.5) decouple update arrival from
relabeling *within* one view; this package generalizes that across a
catalog of views in the Snowflake-Dynamic-Tables style: each view
declares a freshness target (`WITH (target_lag = '5 s' | 'downstream')`),
commits queue per-view batches instead of training synchronously, and a
background daemon decides when to pay SKIING-modeled catch-up cost —
refreshing DAGs of views-over-views in the catalog's topological order.

  state    per-view freshness ledger (inbox, stamps, SUSPEND flag)
  refresh  delivery + refresh mechanics (the ONLY module that mutates
           freshness state — rule FRS001 in `repro.analysis` pins this)
  daemon   the `FreshnessScheduler` thread and its priority policy
"""
from repro_torch.scheduler.daemon import FreshnessScheduler
from repro_torch.scheduler.refresh import refresh_all, schedule_snapshot
from repro_torch.scheduler.state import Batch, ViewRuntime

__all__ = ["FreshnessScheduler", "refresh_all", "schedule_snapshot",
           "Batch", "ViewRuntime"]
