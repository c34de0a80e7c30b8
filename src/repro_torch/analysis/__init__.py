"""The port's invariant tooling, the counterpart of `repro.analysis`:
static passes and the runtime lock-order witness.

Static suite (CLI: `python -m repro_torch.analysis [paths...]`; no path:
the port's own tree, `src/repro_torch`):

  * LCK001-4  lock order / acquire shape / blocking or disk reads under
              the pool lock (`repro_torch.analysis.locks`)
  * SRC001-2  single-source algorithm rules (`.single_source`)
  * PUR001-4  core purity + EngineState immutability (`.purity`), with
              what the port adds: Layer 2 steps known by their
              `EngineState` argument, torch's in-place forms
  * TEL001    single-source timing: raw clock calls outside
              `repro_torch.obs` (`.telemetry`)
  * FRS001    single-source freshness: DAG order from the catalog's
              topological sort only; view freshness state mutated only
              inside `repro_torch.scheduler` (`.freshness`)

The rule ids, the `file:line: RULE message` lines, `--rules` and the exit
codes are the reference's, and so are the exemptions by path part
(`core/engine.py`, `obs/`, `scheduler/`, `rdbms/catalog.py`,
`benchmarks/`) and the lock names (`EpochGate`, `UpdateLog._commit_lock`,
`BufferPool._lock`): on the reference's own tree the passes find what its
`repro.analysis` finds.

Runtime witness (`repro_torch.analysis.witness`, `REPRO_LOCK_WITNESS=1`):
asserts the same gate < wal_commit < pool order live, per thread, with
zero overhead when disabled.

This module keeps imports lazy: `repro_torch.storage` and
`repro_torch.rdbms` import the witness on their construction paths, and
must not drag the `ast` machinery in with it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.analysis.witness import (LOCK_ORDER, REENTRANT,
                                          LockOrderError, WitnessedLock,
                                          assert_unlocked, enabled, wrap)

__all__ = ["LOCK_ORDER", "REENTRANT", "LockOrderError", "WitnessedLock",
           "assert_unlocked", "enabled", "run", "wrap"]


def run(files: Optional[Sequence] = None,
        rules: Sequence[str] = ("LCK", "SRC", "PUR", "TEL", "FRS")) -> List:
    """Run the selected pass families; returns sorted `Finding`s."""
    from repro_torch.analysis.callgraph import CallGraph
    from repro_torch.analysis.common import ModuleSet, default_files
    from repro_torch.analysis.freshness import check_freshness
    from repro_torch.analysis.locks import check_locks
    from repro_torch.analysis.purity import check_purity
    from repro_torch.analysis.single_source import check_single_source
    from repro_torch.analysis.telemetry import check_telemetry

    modules = ModuleSet(default_files() if files is None else files)
    findings = []
    if "LCK" in rules:
        findings += check_locks(modules, CallGraph(modules))
    if "SRC" in rules:
        findings += check_single_source(modules)
    if "PUR" in rules:
        findings += check_purity(modules)
    if "TEL" in rules:
        findings += check_telemetry(modules)
    if "FRS" in rules:
        findings += check_freshness(modules)
    return sorted(findings)
