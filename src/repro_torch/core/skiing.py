"""The SKIING strategy (paper §3.2.1, Fig. 7), counterpart of
`repro.core.skiing`.

SKIING: accumulate incremental-step costs a += c_i; when a ≥ αS,
reorganize and reset a. α is the positive root of x² + σx − 1 (σ =
scan/reorg ratio), which makes the strategy (1 + α + σ)-competitive.

`skiing_schedule` runs SKIING over a cost oracle and `opt_cost` is the
O(N²) offline dynamic program over monotone cost matrices, the pair the
property tests hold against each other:
    cost(SKIING) ≤ (1 + α + σ) · cost(OPT) + O(S).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Tuple

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


def skiing_schedule(costs: Callable[[int, int], float], n: int, S: float,
                    alpha: float = 1.0) -> Tuple[List[int], float]:
    """Run SKIING over rounds 1..n with cost oracle costs(s, i) (cost of an
    incremental step at round i when last reorg was at s). Returns
    (reorg rounds, total cost)."""
    sk = Skiing(S=S, alpha=alpha)
    s = 0
    schedule = []
    total = 0.0
    for i in range(1, n + 1):
        c = costs(s, i)
        # decision per Fig. 7: reorganize when accumulated cost has reached αS
        if skiing_due(sk.a, alpha, S):
            schedule.append(i)
            sk.record_reorg()
            s = i
            total += S
        else:
            sk.record_incremental(c)
            total += c
    return schedule, total


def opt_cost(costs: Callable[[int, int], float], n: int, S: float) -> float:
    """Offline optimum via DP. f[t] = best cost of rounds 1..t with a
    reorganization at round t (round t costs S). Answer considers a last
    segment with no further reorgs."""
    INF = float("inf")
    # pref[s][t] = sum_{i=s+1..t} costs(s, i), computed lazily per s
    f = [INF] * (n + 1)
    f[0] = 0.0
    seg = [[0.0] * (n + 1) for _ in range(n + 1)]
    for s in range(n + 1):
        run = 0.0
        for i in range(s + 1, n + 1):
            run += costs(s, i)
            seg[s][i] = run
    for t in range(1, n + 1):
        best = INF
        for s in range(t):
            c = f[s] + (seg[s][t - 1] if t - 1 >= s + 1 else 0.0) + S
            if c < best:
                best = c
        f[t] = best
    ans = seg[0][n]  # never reorganize
    for s in range(1, n + 1):
        tail = seg[s][n] if n >= s + 1 else 0.0
        ans = min(ans, f[s] + tail)
    return ans
