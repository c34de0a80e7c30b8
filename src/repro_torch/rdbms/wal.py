"""Group-commit update log (WAL-style, replayable).

Heavy write traffic must not pay one engine maintenance round per DML
statement — the batched `insert_examples` path exists precisely so k
training inserts amortize into ONE `apply_model` round. The log is the
relational face of that amortization:

  * every INSERT/UPDATE/DELETE appends a `WalRecord` (monotone LSNs) to a
    per-table pending group and to the durable history;
  * a group commits when it reaches `group_size`, when a read arrives on
    one of the table's views (read-your-writes: SELECTs always observe all
    submitted DML), on `COMMIT` / `UPDATE MODEL`, or on explicit `flush`;
  * a commit feeds each view of the table one batched
    `facade.insert_examples` call (DELETE breaks the batch: it retrains
    non-incrementally per paper footnote 2, so order is preserved around
    it) and appends a commit marker to the history;
  * the history (optionally mirrored to a JSONL file) replays into a fresh
    catalog with identical commit boundaries — `replay_into` is the
    recovery path, and the equivalence tests replay it against direct
    engine calls.

Concurrency: appends and commits are serialized behind ONE explicit
commit lock (`_commit_lock`). N server sessions share one log; without
the lock two sessions' appends interleave inside the pending-group list
mid-`flush` (records silently dropped from the popped group) and two
concurrent flushes double-feed the same batch to the engines. Point
reads never take this lock — they proceed under the executor's shared
epoch gate while writers queue behind it.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Dict, List, Optional

from repro_torch.analysis.witness import wrap
from repro_torch.obs.metrics import DEFAULT_COUNT_BUCKETS
from repro_torch.obs.trace import span as _span
from repro_torch.rdbms.ast_nodes import SqlError


@dataclasses.dataclass
class WalRecord:
    lsn: int
    op: str                    # insert | update | delete | commit
    table: str
    entity_id: int = -1
    label: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(line: str) -> "WalRecord":
        return WalRecord(**json.loads(line))


class UpdateLog:
    def __init__(self, group_size: int = 64, path: Optional[str] = None,
                 metrics=None):
        assert group_size >= 1
        self.group_size = int(group_size)
        self.path = path
        self._fh = open(path, "a") if path else None
        self._commit_lock = wrap(threading.RLock(), "wal_commit")
        self.history: List[WalRecord] = []
        self.pending: Dict[str, List[WalRecord]] = {}
        self.lsn = 0
        self.commits = 0
        self._metrics = metrics
        if metrics is not None:
            self._m_appends = metrics.counter("wal.appends")
            self._m_commits = metrics.counter("wal.commits")
            self._m_group = metrics.histogram("wal.group_size",
                                              DEFAULT_COUNT_BUCKETS)
        else:
            self._m_appends = self._m_commits = self._m_group = None

    # -- append --------------------------------------------------------
    def _record(self, op: str, table: str, entity_id: int = -1,
                label: float = 0.0) -> WalRecord:
        self.lsn += 1
        rec = WalRecord(self.lsn, op, table, int(entity_id), float(label))
        self.history.append(rec)
        if self._fh:
            self._fh.write(rec.to_json() + "\n")
            self._fh.flush()
        return rec

    def append(self, op: str, table: str, entity_id: int, label: float,
               catalog) -> int:
        """Log one DML record; auto-commits the table's group when it
        reaches `group_size`. Returns the number of commits triggered."""
        if op not in ("insert", "update", "delete"):
            raise SqlError(f"bad WAL op {op!r}")
        with self._commit_lock:
            self.pending.setdefault(table, []).append(
                self._record(op, table, entity_id, label))
            if self._m_appends is not None:
                self._m_appends.inc()
            if len(self.pending[table]) >= self.group_size:
                return self.flush(catalog, table)
            return 0

    def has_pending(self, table: Optional[str] = None) -> bool:
        """Any uncommitted DML (for `table`, or anywhere)? Read-your-writes
        checks this before deciding whether a read must flush first."""
        with self._commit_lock:
            if table is not None:
                return bool(self.pending.get(table))
            return any(self.pending.values())

    # -- commit --------------------------------------------------------
    def flush(self, catalog, table: Optional[str] = None) -> int:
        """Commit pending groups (one table, or all). Each commit is ONE
        batched engine round per view; DELETEs preserve statement order by
        splitting the batch around the retrain."""
        with self._commit_lock:
            with _span("wal.commit", metrics=self._metrics) as sp:
                n = self._flush_locked(catalog, table)
                sp.attrs["commits"] = n
            return n

    def _flush_locked(self, catalog, table: Optional[str] = None) -> int:
        tables = [table] if table is not None else list(self.pending)
        commits = 0
        for t in tables:
            group = self.pending.pop(t, [])
            if not group:
                continue
            # the catalog's view DAG decides per-view what "apply" means:
            # immediate views train right here (one batched engine round,
            # exactly the old inline feed); scheduled views queue the
            # batch in their inbox for the freshness scheduler
            catalog.deliver_group(t, group)
            self._record("commit", t)
            self.commits += 1
            commits += 1
            if self._m_commits is not None:
                self._m_commits.inc()
                self._m_group.observe(len(group))
        return commits

    # -- telemetry -----------------------------------------------------
    def telemetry_snapshot(self) -> Dict[str, object]:
        """Collector payload for the metrics registry (`wal` key)."""
        with self._commit_lock:
            return {
                "commits": self.commits,
                "lsn": self.lsn,
                "group_size": self.group_size,
                "pending_tables": sum(1 for g in self.pending.values() if g),
                "pending_records": sum(len(g) for g in self.pending.values()),
            }

    # -- recovery ------------------------------------------------------
    @staticmethod
    def replay_into(history: List[WalRecord], catalog,
                    group_size: int = 64) -> "UpdateLog":
        """Re-apply a history against a fresh catalog (tables and views
        already created). Commit markers in the history reproduce the
        original commit boundaries exactly, whatever `group_size` was."""
        log = UpdateLog(group_size=max(group_size, len(history) + 1))
        for rec in history:
            if rec.op == "commit":
                log.pending.setdefault(rec.table, [])
                log.flush(catalog, rec.table)
            else:
                log.pending.setdefault(rec.table, []).append(
                    log._record(rec.op, rec.table, rec.entity_id, rec.label))
        return log

    @staticmethod
    def load(path: str) -> List[WalRecord]:
        with open(path) as fh:
            return [WalRecord.from_json(line) for line in fh
                    if line.strip()]

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
