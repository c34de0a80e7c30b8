"""The SKIING strategy (paper §3.2.1, Fig. 7), counterpart of
`repro.core.skiing`.

SKIING: accumulate incremental-step costs a += c_i; when a ≥ αS,
reorganize and reset a. α is the positive root of x² + σx − 1 (σ =
scan/reorg ratio), which makes the strategy (1 + α + σ)-competitive.
The offline `skiing_schedule` / `opt_cost` pair is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.engine import skiing_charge, skiing_due


def alpha_star(sigma: float) -> float:
    """Positive root of x² + σx − 1."""
    return (-sigma + math.sqrt(sigma * sigma + 4.0)) / 2.0


@dataclasses.dataclass
class Skiing:
    S: float                  # reorganization cost; updated on reorg
    alpha: float = 1.0
    a: float = 0.0            # accumulated incremental cost
    reorgs: int = 0
    total_incremental: float = 0.0

    def should_reorganize(self) -> bool:
        return bool(skiing_due(self.a, self.alpha, self.S))

    def record_incremental(self, c: float) -> bool:
        """Add one incremental-step cost; returns True if a reorg is due."""
        self.a = skiing_charge(self.a, c)
        self.total_incremental += c
        return self.should_reorganize()

    def record_reorg(self, measured_S: float = None):
        self.a = 0.0
        self.reorgs += 1
        if measured_S is not None and measured_S > 0:
            self.S = measured_S

    @property
    def total_cost(self) -> float:
        return self.total_incremental + self.reorgs * self.S
