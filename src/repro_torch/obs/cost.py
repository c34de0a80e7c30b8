"""Measured-cost SKIING hooks: per-view wall-clock cost recorders.

The engines charge *modeled* SKIING costs (in ``cost_mode="modeled"`` those
are deterministic fractions of a scan, pinned so equivalence tests stay
bitwise); a ``ViewCostRecorder`` records the *measured* wall-clock cost of
the same reorganize / incremental / catch-up work alongside, without ever
feeding back into the modeled charges. ``SHOW COST ON <view>`` reports the
modeled-vs-measured ratio per view — the seconds-per-modeled-unit exchange
rate a freshness scheduler needs to turn SKIING charges into wall time.
Counterpart of `repro.obs.cost`.

What a recorded wall covers on a CUDA device: in `cost_mode="measured"`
the engines synchronize the device before each clock read, so a record is
the work itself (launches and kernels) and SKIING runs on it. In
`"modeled"` mode the schedule never reads the clock and the engines add no
synchronization: a record then covers the host time to enqueue the work
plus whatever host round trips the step makes (band bounds, counts), not
the device time of its kernels.
"""
from __future__ import annotations

import threading
from typing import Any, Dict

from repro_torch.obs.metrics import DEFAULT_TIME_BUCKETS, Histogram


class ViewCostRecorder:
    """Wall-clock reorg/step timings + modeled-charge totals for k views."""

    def __init__(self, k: int = 1) -> None:
        self.k = int(k)
        self._lock = threading.Lock()
        self.reorg_hist = [Histogram(DEFAULT_TIME_BUCKETS) for _ in range(self.k)]
        self.step_hist = [Histogram(DEFAULT_TIME_BUCKETS) for _ in range(self.k)]
        self.charge_modeled = [0.0] * self.k
        self.seconds_measured = [0.0] * self.k
        self.reorg_seconds = [0.0] * self.k

    def record_reorg(self, v: int, seconds: float) -> None:
        self.reorg_hist[v].observe(seconds)
        with self._lock:
            self.reorg_seconds[v] += seconds

    def record_step(self, v: int, seconds: float, charge: float) -> None:
        """One incremental/catch-up step: measured wall seconds alongside the
        modeled charge actually fed to SKIING."""
        self.step_hist[v].observe(seconds)
        with self._lock:
            self.seconds_measured[v] += seconds
            self.charge_modeled[v] += float(charge)

    def snapshot(self, v: int) -> Dict[str, Any]:
        with self._lock:
            modeled = self.charge_modeled[v]
            measured = self.seconds_measured[v]
            reorg_s = self.reorg_seconds[v]
        rh, sh = self.reorg_hist[v], self.step_hist[v]
        return {
            "reorgs_measured": rh.count,
            "S_measured_mean_s": rh.mean,
            "reorg_seconds": reorg_s,
            "steps_measured": sh.count,
            "step_p50_s": sh.quantile(0.50),
            "step_p99_s": sh.quantile(0.99),
            "charge_modeled": modeled,
            "seconds_measured": measured,
            "seconds_per_charge": (measured / modeled) if modeled > 0 else None,
        }
