"""Straggler mitigation: detection + deterministic data-shard reassignment.
The port's copy of `repro/distributed/straggler.py`, unchanged: pure logic
that imports neither jax nor torch.

At 1000+ nodes, persistent stragglers (thermal throttling, failing NICs)
stretch every synchronous step. Two pieces, both pure logic (unit-tested
without hardware):

  * StragglerDetector — per-worker EMA of step times; a worker whose EMA
    exceeds `threshold` x the fleet median for `patience` consecutive
    checks is flagged.
  * ShardAssigner — maps data shards -> workers. Because the data pipeline
    is a pure function of (seed, step, shard) [see data/lm.py], moving a
    shard to another worker needs zero data movement: the new owner just
    generates/reads that shard's stream. Flagged workers get their shards
    reassigned to the fastest workers (who run 2 shards — better a 2x load
    on a fast node than a 5x-slow critical path), and the slow worker is
    marked for eviction at the next checkpoint boundary (elastic re-mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class StragglerDetector:
    n_workers: int
    ema_alpha: float = 0.2
    threshold: float = 1.5
    patience: int = 3

    def __post_init__(self):
        self.ema: List[Optional[float]] = [None] * self.n_workers
        self.strikes: List[int] = [0] * self.n_workers

    def observe(self, step_times: Dict[int, float]) -> List[int]:
        """Feed per-worker step times; returns list of flagged workers."""
        for w, t in step_times.items():
            e = self.ema[w]
            self.ema[w] = t if e is None else (1 - self.ema_alpha) * e + self.ema_alpha * t
        known = sorted(e for e in self.ema if e is not None)
        if not known:
            return []
        median = known[len(known) // 2]
        flagged = []
        for w in range(self.n_workers):
            e = self.ema[w]
            if e is not None and median > 0 and e > self.threshold * median:
                self.strikes[w] += 1
                if self.strikes[w] >= self.patience:
                    flagged.append(w)
            else:
                self.strikes[w] = 0
        return flagged


@dataclasses.dataclass
class ShardAssigner:
    n_shards: int
    n_workers: int

    def __post_init__(self):
        assert self.n_shards >= self.n_workers
        self.assignment: Dict[int, List[int]] = {
            w: [s for s in range(self.n_shards) if s % self.n_workers == w]
            for w in range(self.n_workers)
        }
        self.evicted: List[int] = []

    def reassign(self, flagged: List[int], detector: StragglerDetector):
        """Move flagged workers' shards to the fastest healthy workers."""
        healthy = [w for w in range(self.n_workers)
                   if w not in flagged and w not in self.evicted]
        if not healthy:
            return self.assignment
        healthy.sort(key=lambda w: detector.ema[w] or 0.0)
        for w in flagged:
            if w in self.evicted:
                continue
            shards = self.assignment.pop(w, [])
            for i, s in enumerate(shards):
                dst = healthy[i % len(healthy)]
                self.assignment[dst].append(s)
            self.evicted.append(w)
        return self.assignment

    def owner_of(self, shard: int) -> int:
        for w, shards in self.assignment.items():
            if shard in shards:
                return w
        raise KeyError(shard)
