"""Per-view freshness runtime state (the scheduler's ledger).

Every `ViewDef` carries one `ViewRuntime`. The fields here — the inbox of
committed-but-unapplied batches, the suspension flag, the staleness and
last-refresh stamps — are the scheduler's OWN state: the FRS001 analysis
rule pins every mutation of them to this package, so refresh semantics
cannot fork across modules (`repro.analysis.freshness`).

A `Batch` is one WAL commit's worth of training rows as ONE engine round:
`(ids, labels, features)`. `features` is None for batches delivered to a
root view (the engine reads the base table's rows) and a pinned
`(len(ids), d)` matrix for batches a parent view emitted to a derived
view — the input features are computed ONCE, at emission time, from the
parent's post-batch model, so a derived view trains on the same feature
values no matter how late its refresh runs. That pinning is what makes
the lagged cascade bit-identical to an immediate one at the same commit
boundaries.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.obs.cost import ViewCostRecorder


@dataclasses.dataclass
class Batch:
    ids: List[int]
    labels: List[float]
    features: Optional[np.ndarray] = None   # pinned inputs (derived views)

    def __len__(self) -> int:
        return len(self.ids)


class ViewRuntime:
    """Freshness state of one view. Mutated ONLY inside `repro_torch.scheduler`
    (enforced by FRS001); everyone else reads."""

    __slots__ = ("suspended", "inbox", "stale_since", "last_refresh_at",
                 "refreshes", "batches_applied", "rows_applied", "version",
                 "upstream_version_seen", "cost")

    def __init__(self, upstream_version_seen: int = -1):
        self.suspended = False
        self.inbox: List[Batch] = []        # committed, not yet applied
        self.stale_since: Optional[float] = None   # earliest unserved commit
        self.last_refresh_at: Optional[float] = None
        self.refreshes = 0
        self.batches_applied = 0
        self.rows_applied = 0
        # bumped whenever this view's labels/margins may have changed
        # (a consumed batch or a feature refresh) — consumers compare it
        # against `upstream_version_seen` to skip no-op feature pulls
        self.version = 0
        self.upstream_version_seen = upstream_version_seen
        # measured wall-clock refresh cost, recorded ALONGSIDE the modeled
        # SKIING charge the scheduler actually uses — never scheduling
        self.cost = ViewCostRecorder(1)

    def inbox_rows(self) -> int:
        return sum(len(b) for b in self.inbox)

    def staleness(self, now: float) -> float:
        return 0.0 if self.stale_since is None else max(0.0, now - self.stale_since)
