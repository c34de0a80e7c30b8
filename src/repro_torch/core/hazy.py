"""HAZY incremental maintenance of one classification view (paper
§3.2–3.5), counterpart of `repro.core.hazy`: the k = 1 stateful shell over
the Layer 1 rules of `core/engine.py`, with its state on a device.

On the engine's device: the entity table `F`, the materialized eps-sorted
table `F_sorted` (the clustering gather is the dominant reorganization
cost), `eps_sorted`, `perm` / `inv_perm` (the hybrid eps-map: id -> eps is
`eps_sorted[inv_perm[id]]`), `labels_sorted` and the positive count. On
the host, as in the reference: the current and stored models (f32 numpy
w, float b), `Waters` (float64) and `Skiing`.

The products go through the kernels' dispatch (`ops.py`: the CUDA kernel
on a GPU, the plain version on the CPU):

  * reorganize, `NaiveEngine`'s relabel and `check_consistent` — one
    `eps_affine` pass gives eps = F·w − b, the sign labels and the count;
  * the banded step and the lazy catch-up — `band_reclassify_rows` over
    the band [lo, hi) of `F_sorted`, in place.

The positive count is taken from the labels when it is read (one
reduction over n), which equals the count the reference moves by each
band's delta; counting the band before and after instead costs a banded
round 8 more device operations, and rounds outnumber count reads.

Single-row probes are one dot on the row. Exactness against the numpy
reference: the band is searched as numpy searches float32 eps at float64
waters (`engine.band_bounds`), and the point probe compares in float32,
as numpy does between a float32 scalar and a Python float.

Cost accounting as in the reference: `cost_mode="measured"` feeds wall
time to SKIING, `"modeled"` charges S·(band/n) with S pinned to 1.
Measured mode on a GPU synchronizes the device before each clock read, so
SKIING sees the work and not its launch; modeled mode adds no
synchronization (see `obs/cost.py` for what its records cover).

The storage tier (`store=BufferPool(...)`, `repro_torch.storage`): a
probe the waters cannot resolve reads its row through the pool — a hot
buffer hit only when the row's page is resident (pinned), else
`store.touch` answers "pool" (resident) or "disk" (a cold page read,
counted in `disk_touches`) — and classifies it on the host, against the
host model, as the reference does: an f32 dot, then `b` subtracted in
f32. Each reorganize re-warms the pool: the hot window's pages are
pinned, then pages are prefetched in boundary-outward eps order
(`perm[argsort(|eps_sorted|, stable)]`, sorted on the device; the order
and the window's ids reach the host in one copy). The maintenance scans
read the device copies of F, never the pool.

Host round trips (the host waits for the device): an eager banded round
1 (the band bounds), a reorganize 0 (1 with a hot buffer, 1 more with a
store), a lazy catch-up 2 (the band bounds, the count for the §3.4
waste), a hybrid probe 1, plus 1 when the waters cannot resolve it and
no store is attached, a count read 1; measured mode adds a
synchronization before each clock read. A new model is one copy to the
device (w and b together).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import (argsort_stable, band_bounds, classify,
                                     host_classify, hot_buffer_window,
                                     probe_partition)
from repro_torch.core.linear_model import LinearModel, zero_model
from repro_torch.core.skiing import Skiing, alpha_star
from repro_torch.core.waters import Waters, holder_M
from repro_torch.device import full_fp32, resolve_device
from repro_torch.kernels.band_reclassify.ops import band_reclassify_rows
from repro_torch.kernels.eps_affine.ops import eps_affine
from repro_torch.obs import clock
from repro_torch.obs.cost import ViewCostRecorder

@dataclasses.dataclass
class Stats:
    rounds: int = 0
    reorgs: int = 0
    tuples_reclassified: int = 0
    tuples_total_possible: int = 0
    band_fraction_last: float = 0.0
    incremental_seconds: float = 0.0
    reorg_seconds: float = 0.0


def _device_table(F: np.ndarray, on_device: Optional[torch.Tensor],
                  device: torch.device) -> torch.Tensor:
    """The engine's device copy of the host table F: `on_device` where the
    caller shares one (the k engines of a `MulticlassView` read one
    table), else a copy of its own."""
    if on_device is None:
        return torch.tensor(F, device=device)
    if (on_device.device.type != device.type
            or on_device.dtype != torch.float32
            or tuple(on_device.shape) != F.shape):
        raise ValueError("features_on_device must be F's float32 copy on "
                         "the engine's device")
    return on_device


class _DeviceModel:
    """A host `LinearModel` (w f32, float b) and its device copies: w, and
    b rounded to f32, as numpy rounds a Python float against f32 data (one
    copy to the device for both). Setting `model` refreshes the copies, so
    a caller may assign it."""

    device: torch.device

    @property
    def model(self) -> LinearModel:
        return self._model

    @model.setter
    def model(self, m: LinearModel):
        self._model = m
        wb = torch.tensor(np.append(np.asarray(m.w, np.float32),
                                    np.float32(m.b)), device=self.device)
        self._w, self._b = wb[:-1], wb[-1]

    def _row_label(self, f: torch.Tensor) -> int:
        """sign(f·w − b) of one feature row under the current model."""
        return int(classify(torch.dot(f, self._w) - self._b))


class HazyEngine(_DeviceModel):
    """Eager/lazy/hybrid incremental maintenance of one binary view.
    `device=None` means the GPU."""

    def __init__(self, features: np.ndarray, *, p: float = float("inf"),
                 q: float = 1.0, alpha: float = 1.0, policy: str = "eager",
                 cost_mode: str = "measured", touch_ns: float = 0.0,
                 buffer_frac: float = 0.0, store=None, device=None,
                 features_on_device: Optional[torch.Tensor] = None):
        if policy not in ("eager", "lazy", "hybrid"):
            raise ValueError(f"unknown policy {policy!r}")
        self.device = resolve_device(device)
        full_fp32()
        F = np.ascontiguousarray(features, np.float32)
        self.n, self.d = F.shape
        self.F = _device_table(F, features_on_device, self.device)
        self.policy = policy
        self._defers = policy in ("lazy", "hybrid")
        self.cost_mode = cost_mode
        self.touch_ns = touch_ns
        self._sync = self.device.type == "cuda" and cost_mode == "measured"
        self.M = holder_M(F, q)
        self.waters = Waters(p=p, M=self.M)
        self.model = zero_model(self.d)
        self.stored = self.model.copy()
        self.stats = Stats()
        self.buffer_frac = buffer_frac
        self._buffer_lo = 0
        self._buffer_hi = 0
        # optional memory-budgeted storage tier (repro_torch.storage
        # BufferPool): probes the waters cannot resolve read through it
        # and the hot buffer is its pinned pages
        self.store = store
        self.disk_touches = 0      # probes that paid a cold row read
        self._eps_order = None     # boundary-outward eps order (readahead)
        self._eps_pos = None       # entity id -> position in _eps_order
        # measured-cost telemetry, recorded alongside the modeled charges
        # and never fed back into them
        self.cost = ViewCostRecorder(1)
        t0 = self._clock()
        self._do_reorganize()
        S0 = max(self._clock() - t0, 1e-9)
        t0 = self._clock()
        float(torch.sum(self.eps_sorted))
        scan = max(self._clock() - t0, 1e-12)
        self.sigma = min(1.0, scan / S0)
        # modeled mode pins S to 1.0 (dimensionless charges, bitwise
        # deterministic schedules); measured mode keeps the wall-time S
        S_init = 1.0 if cost_mode == "modeled" else S0
        self.skiing = Skiing(S=S_init,
                             alpha=(alpha if alpha else alpha_star(self.sigma)))
        self._pending: Optional[LinearModel] = None

    def _clock(self) -> float:
        """The host clock, after the device's work in measured mode."""
        if self._sync:
            torch.cuda.synchronize(self.device)
        return clock()

    @property
    def pos_count(self) -> int:
        return int((self.labels_sorted == 1).sum())

    # ------------------------------------------------------------------
    # Organization
    # ------------------------------------------------------------------

    def _set_order(self, perm, eps_sorted, labels_sorted):
        """The eps-sorted order: perm, its inverse, eps and labels in that
        order, and the clustering gather `F_sorted` (the dominant
        reorganization cost)."""
        self.perm = perm
        self.inv_perm = torch.empty_like(perm)
        self.inv_perm[perm] = torch.arange(self.n, device=self.device)
        self.eps_sorted = eps_sorted
        self.labels_sorted = labels_sorted
        self.F_sorted = self.F[perm]

    def _do_reorganize(self):
        eps, labels, _ = eps_affine(self.F, self._w, self._b)
        perm = argsort_stable(eps)
        self._set_order(perm, eps[perm], labels[perm])
        self.stored = self.model.copy()
        self.waters.reset()
        if self.buffer_frac:
            lo, hi = hot_buffer_window(self.eps_sorted,
                                       int(self.buffer_frac * self.n))
            self._buffer_lo, self._buffer_hi = torch.stack([lo, hi]).tolist()
        if self.store is not None:
            self._rewarm_store()

    def _rewarm_store(self):
        """Re-warm the pool along the new clustering order (the eps order
        is the locality order): pin the hot window's pages, then prefetch
        pages in boundary-outward eps order until the budget is full —
        through an attached `Prefetcher`'s worker, else inline. The order
        is sorted on the device (a stable sort of |eps| gives numpy's
        order) and copied to the host once, with the window's ids."""
        lo, hi = self._buffer_lo, self._buffer_hi
        order = self.perm[argsort_stable(self.eps_sorted.abs())]
        ids = torch.cat([self.perm[lo:hi], order]).cpu().numpy()
        self.store.repin_rows(ids[:hi - lo])
        self._eps_order = order = ids[hi - lo:]
        self._eps_pos = None                  # built at the first hint
        pre = getattr(self.store, "prefetcher", None)
        if pre is not None:
            pre.enqueue(order)
        else:
            self.store.warm(order)

    def _hint_readahead(self, entity_id: int, window: int = 64):
        """Band-probe miss at eps-position p: enqueue the next `window`
        entities boundary-outward (the next-most-likely misses, on the
        next pages). No-op without an attached prefetcher."""
        pre = getattr(self.store, "prefetcher", None)
        if pre is None or self._eps_order is None:
            return
        if self._eps_pos is None:
            self._eps_pos = np.empty(self.n, np.int64)
            self._eps_pos[self._eps_order] = np.arange(self.n)
        p = int(self._eps_pos[entity_id])
        nxt = self._eps_order[p + 1:p + 1 + window]
        if nxt.size:
            pre.enqueue(nxt, evict=True)

    def restore(self, perm: np.ndarray, eps_sorted: np.ndarray,
                labels_sorted: np.ndarray, **host):
        """Continue from another engine's state (see `core.convert`): the
        eps-sorted order `perm` with its `eps_sorted` and `labels_sorted`
        (host arrays), and each host attribute named in `host`, set as
        given."""
        for name, value in host.items():
            setattr(self, name, value)
        dev = self.device
        self._set_order(
            torch.tensor(perm, dtype=torch.int64, device=dev),
            torch.tensor(eps_sorted, dtype=torch.float32, device=dev),
            torch.tensor(labels_sorted, dtype=torch.int8, device=dev))

    def reorganize(self):
        t0 = self._clock()
        self._do_reorganize()
        S = self._clock() - t0 + self.touch_ns * 1e-9 * self.n
        self.skiing.record_reorg(None if self.cost_mode == "modeled" else S)
        self.stats.reorgs += 1
        self.stats.reorg_seconds += S
        self.cost.record_reorg(0, S)

    # ------------------------------------------------------------------
    # Incremental step (paper Fig. 2): reclassify only the water band
    # ------------------------------------------------------------------

    def _band(self) -> Tuple[int, int]:
        """[lw, hw) of the eps-sorted row, as host ints (one round trip)."""
        lo, hi = band_bounds(self.eps_sorted, self.waters.lw, self.waters.hw)
        return int(lo), int(hi)

    def _relabel(self, lo: int, hi: int):
        """Rows [lo, hi) of the eps-sorted table under the current model,
        in place."""
        band_reclassify_rows(self.F_sorted, self.labels_sorted, self._w,
                             self._b, lo, hi - lo)

    def _incremental_step(self) -> float:
        """Reclassify the band under the *current* model. Returns cost."""
        t0 = self._clock()
        lo, hi = self._band()
        width = hi - lo
        if width > 0:
            self._relabel(lo, hi)
        wall = self._clock() - t0 + self.touch_ns * 1e-9 * width
        self.stats.tuples_reclassified += width
        self.stats.tuples_total_possible += self.n
        self.stats.band_fraction_last = width / max(1, self.n)
        c = (self.skiing.S * (width / max(1, self.n))
             if self.cost_mode == "modeled" else wall)
        self.cost.record_step(0, wall, c)
        return c

    def apply_model(self, model: LinearModel):
        """One round: the view must reflect `model` (eager) or remember it
        (lazy). SKIING decides reorg-vs-incremental (Fig. 7: check first)."""
        self.model = model.copy()
        self.stats.rounds += 1
        if self._defers:
            self._pending = self.model
            if self.policy == "hybrid":
                # §3.5.2: the relabel stays deferred, but SKIING still
                # decides reorgs on updates, charging the expected probe
                # miss rate (the band fraction)
                self.waters.update(self.model, self.stored)
                lo, hi = self._band()
                miss = self.skiing.S * ((hi - lo) / max(1, self.n))
                if self.skiing.record_incremental(miss):
                    self.reorganize()
                    self._pending = None
            return
        if self.skiing.should_reorganize():
            self.reorganize()
        else:
            self.waters.update(self.model, self.stored)
            c = self._incremental_step()
            self.skiing.record_incremental(c)
            self.stats.incremental_seconds += c

    def _lazy_catch_up(self):
        if self._pending is None:
            return
        self.waters.update(self.model, self.stored)
        lo, hi = self._band()
        width = hi - lo
        t0 = self._clock()
        if width:
            self._relabel(lo, hi)
        self._pending = None
        # lazy cost accounting (paper §3.4): waste = (N_R − N_+)/N_R · S
        n_read = self.n - lo
        waste = (n_read - self.pos_count) / max(1, n_read)
        wall = self._clock() - t0 + self.touch_ns * 1e-9 * width
        c = (wall if self.cost_mode == "measured"
             else self.skiing.S * max(0.0, waste))
        self.cost.record_step(0, wall, max(0.0, c))
        self.stats.tuples_reclassified += width
        self.stats.tuples_total_possible += self.n
        self.stats.incremental_seconds += max(0.0, c)
        if self.skiing.record_incremental(max(0.0, c)):
            self.reorganize()

    # ------------------------------------------------------------------
    # Reads
    # ------------------------------------------------------------------

    def all_members(self) -> int:
        """'How many entities with label 1?' (paper's All Members probe)."""
        if self._defers:
            self._lazy_catch_up()
        return self.pos_count

    def members(self) -> np.ndarray:
        if self._defers:
            self._lazy_catch_up()
        return self.perm[self.labels_sorted == 1].cpu().numpy()

    def label(self, entity_id: int) -> int:
        if self._defers:
            self._lazy_catch_up()
        return int(self.labels_sorted[self.inv_perm[entity_id]])

    def hybrid_label(self, entity_id: int) -> Tuple[int, str]:
        """eps-map + waters + buffer (paper §3.5.2, Fig. 8); returns
        (label, how) with how ∈ {water, buffer, disk}, and "pool" for a
        resident row read through a storage tier. Exact under every
        policy: a pending model only needs the monotone waters update."""
        if self._pending is not None:
            self.waters.update(self.model, self.stored)
        pos = self.inv_perm[entity_id]
        t = probe_partition(self.eps_sorted[pos], self.waters.lw,
                            self.waters.hw)
        t, pos = torch.stack([t.to(torch.int64), pos]).tolist()
        if t != 0:
            return t, "water"
        if self.store is None:
            if self._buffer_lo <= pos < self._buffer_hi:
                return self._row_label(self.F_sorted[pos]), "buffer"
            self.disk_touches += 1     # charged as disk_touches * touch_ns
            return self._row_label(self.F[entity_id]), "disk"
        # through the pool: a hot-buffer row is a resident (pinned) page; a
        # window wider than the budget leaves its tail unpinned, and those
        # rows fall through to the pool/disk tiers
        if (self._buffer_lo <= pos < self._buffer_hi
                and self.store.resident(entity_id)):
            f, how = self.store.get_row(entity_id), "buffer"
        else:
            f, how = self.store.touch(entity_id)
            if how == "disk":
                self.disk_touches += 1        # cold page reads only
                self._hint_readahead(entity_id)
        m = self.model
        return int(host_classify(f.numpy() @ m.w - m.b)), how

    # ------------------------------------------------------------------

    def band_fraction(self) -> float:
        if self._defers:
            self._lazy_catch_up()
        lo, hi = self._band()
        return (hi - lo) / max(1, self.n)

    def check_consistent(self) -> bool:
        """Golden invariant: view == naive relabel under the current model
        (after lazy catch-up)."""
        if self._defers:
            self._lazy_catch_up()
        _, truth, _ = eps_affine(self.F_sorted, self._w, self._b)
        return bool(torch.equal(truth, self.labels_sorted))


class NaiveEngine(_DeviceModel):
    """Naïve eager/lazy baselines (paper §2.2): every update (eager) or
    every count read (lazy) relabels all n rows in one `eps_affine` pass.
    `device=None` means the GPU."""

    def __init__(self, features: np.ndarray, *, policy: str = "eager",
                 touch_ns: float = 0.0, device=None,
                 features_on_device: Optional[torch.Tensor] = None):
        self.device = resolve_device(device)
        F = np.ascontiguousarray(features, np.float32)
        self.n, self.d = F.shape
        self.F = _device_table(F, features_on_device, self.device)
        self.policy = policy
        self.touch_ns = touch_ns
        self.model = zero_model(self.d)
        self._relabel()

    def _relabel(self):
        _, self.labels, self._pos = eps_affine(self.F, self._w, self._b)
        if self.touch_ns:
            time.sleep(self.touch_ns * 1e-9 * self.n)

    def apply_model(self, model: LinearModel):
        self.model = model.copy()
        if self.policy == "eager":
            self._relabel()  # full scan + rewrite every update

    def all_members(self) -> int:
        if self.policy == "lazy":
            self._relabel()  # scan and classify every tuple per read
        return int(self._pos)

    def label(self, entity_id: int) -> int:
        if self.policy == "lazy":
            return self._row_label(self.F[entity_id])
        return int(self.labels[entity_id])
