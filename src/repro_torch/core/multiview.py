"""Vectorized multi-view HAZY maintenance: k one-vs-all views over ONE
table, counterpart of `repro.core.multiview`, with its state on a device.

On the engine's device: the feature table `F` (n, d) once, in entity
order; the per-view scratch state as rows of (k, n) tensors —
`eps_sorted`, `perm`, `inv_perm`, `labels_sorted` — the (k,) positive
counts, moved by each band's delta as the reference moves them, and the
hot-buffer rows `buffer_F` (k, cap, d). On the host, as in
the reference: the stacked models `W` (k, d) f32 and `b` (k,) float64,
their stored copies, the waters `lw` / `hw` (k,) float64, the SKIING
accumulators and the pending masks. Each view keeps its own order, so
there is no shared clustering order and the products are plain
`torch.matmul`: a reorganize re-sorts every due view from one
`F @ W[due].T`, and a maintenance round relabels the union of the views'
bands from ONE gather of its rows and ONE product.

Exactness against the numpy reference: bands are searched as numpy
searches float32 eps at float64 waters (`engine.band_bounds`), and point
probes compare float32 eps with the float64 waters in float64, as numpy
does with these operands.

The storage tier (`store=BufferPool(...)`): the hot buffers are pinned
pool pages (no `buffer_F` copy), a probe that misses the waters and the
buffer reads the shared row through the pool ("pool" when resident,
"disk" for a cold read), and the row is classified on the host against
the host `W` and `b` of every view that needs it, as the reference does.
Each reorganize pins every view's hot window and warms the pool in the
shared boundary-outward order (ascending min_v |eps_v|, sorted on the
device; the order and the windows' ids reach the host in one copy).

Cost accounting mirrors `hazy.py` (measured mode on a GPU synchronizes
before each clock read). Host round trips (the host waits for the
device): an eager round 2 (the band bounds; `torch.unique`'s size), a
reorganize 0 (1 with hot buffers), a lazy catch-up 3 (the band bounds,
the union's size, the counts for the §3.4 waste), a hybrid probe 1, plus
1 when some view misses the waters, a count or point read 1; measured
mode adds a synchronization before each clock read. Small host arrays
(the models, the bands' bounds and layout, view ids) are copied to the
device as they are needed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import (PROBE_TIERS, TIER_BUFFER, TIER_DISK,
                                     TIER_POOL, TIER_WATER, argsort_stable,
                                     band_bounds, classify, host_classify,
                                     hot_buffer_window, probe_partition,
                                     skiing_charge, skiing_due, waters_update)
from repro_torch.core.hazy import Stats
from repro_torch.core.skiing import alpha_star
from repro_torch.core.waters import holder_M
from repro_torch.device import full_fp32, resolve_device
from repro_torch.obs import clock
from repro_torch.obs.cost import ViewCostRecorder


class MultiViewEngine:
    """Eager/lazy/hybrid maintenance of k binary views over one shared
    table. `device=None` means the GPU."""

    def __init__(self, features: np.ndarray, num_views: int, *,
                 p: float = float("inf"), q: float = 1.0, alpha: float = 1.0,
                 policy: str = "eager", cost_mode: str = "measured",
                 touch_ns: float = 0.0, buffer_frac: float = 0.0,
                 store=None, device=None):
        if policy not in ("eager", "lazy", "hybrid"):
            raise ValueError(f"unknown policy {policy!r}")
        self.device = dev = resolve_device(device)
        full_fp32()
        F = np.ascontiguousarray(features, np.float32)
        self.n, self.d = F.shape
        self.F = torch.tensor(F, device=dev)
        self.k = int(num_views)
        self.p = p
        self.policy = policy
        self._defers = policy in ("lazy", "hybrid")
        self.cost_mode = cost_mode
        self.touch_ns = touch_ns
        self._sync = dev.type == "cuda" and cost_mode == "measured"
        self.M = holder_M(F, q)

        k, n = self.k, self.n
        self.W = np.zeros((k, self.d), np.float32)
        self.b = np.zeros(k, np.float64)
        self.W_stored = np.zeros((k, self.d), np.float32)
        self.b_stored = np.zeros(k, np.float64)
        self.lw = np.zeros(k, np.float64)
        self.hw = np.zeros(k, np.float64)
        self.perm = torch.zeros((k, n), dtype=torch.int64, device=dev)
        self.inv_perm = torch.zeros((k, n), dtype=torch.int64, device=dev)
        self.eps_sorted = torch.zeros((k, n), dtype=torch.float32, device=dev)
        self.labels_sorted = torch.zeros((k, n), dtype=torch.int8, device=dev)
        self._pos = torch.zeros(k, dtype=torch.int64, device=dev)
        self.pending = np.zeros(k, bool)        # per-view deferred maintenance
        self._waters_stale = np.zeros(k, bool)  # waters behind current model
        self._waters_dirty = False              # scalar mirror of .any()
        self.lazy_waste = np.zeros(k, np.float64)  # §3.4 waste, per view
        # §3.5.2 hot buffer, per view: [buffer_lo, buffer_hi) positions of
        # the eps-sorted order, with the feature rows materialized — or,
        # over a storage tier (repro_torch.storage BufferPool), its pinned
        # pages, and probe misses read through the pool
        self.buffer_frac = buffer_frac
        self.buffer_cap = max(1, int(buffer_frac * n)) if buffer_frac else 0
        self.buffer_lo = np.zeros(k, np.int64)
        self.buffer_hi = np.zeros(k, np.int64)
        self.store = store
        self._eps_order = None   # boundary-outward eps order (readahead)
        self._eps_pos = None     # entity id -> position in _eps_order
        self.buffer_F: Optional[torch.Tensor] = (
            torch.zeros((k, self.buffer_cap, self.d), dtype=torch.float32,
                        device=dev)
            if self.buffer_cap and store is None else None)
        self.hybrid_hits = np.zeros(len(PROBE_TIERS), np.int64)  # per tier
        self.disk_touches = 0        # cold shared F-row reads by probes
        self._arange_k = torch.arange(k, device=dev)
        self._arange_n = torch.arange(n, device=dev)

        # the free initial organization seeds the per-view S; stats, S and
        # acc exist only afterwards (the hasattr guard below)
        self.cost = ViewCostRecorder(k)
        t0 = self._clock()
        self._reorganize_views(np.ones(k, bool))
        S0 = max(self._clock() - t0, 1e-9) / k
        t0 = self._clock()
        float(torch.sum(self.eps_sorted[0]))
        scan = max(self._clock() - t0, 1e-12)
        self.sigma = min(1.0, scan / S0)
        self.alpha = alpha if alpha else alpha_star(self.sigma)
        # modeled mode pins S to 1.0 (bitwise deterministic schedules)
        self.S = np.full(k, 1.0 if cost_mode == "modeled" else S0,
                         np.float64)              # per-view reorg cost
        self.acc = np.zeros(k, np.float64)        # SKIING accumulators
        self.stats = Stats()
        self.reorg_counts = np.zeros(k, np.int64)

    # the host models and their device copies (b rounded to f32, as the
    # reference's products take it); assigning W or b refreshes the copy
    @property
    def W(self) -> np.ndarray:
        return self._W

    @W.setter
    def W(self, W):
        self._W = W
        self._Wd = torch.tensor(np.asarray(W, np.float32), device=self.device)

    @property
    def b(self) -> np.ndarray:
        return self._b

    @b.setter
    def b(self, b):
        self._b = b
        self._bd = torch.tensor(np.asarray(b).astype(np.float32),
                                device=self.device)

    def _clock(self) -> float:
        """The host clock, after the device's work in measured mode."""
        if self._sync:
            torch.cuda.synchronize(self.device)
        return clock()

    @property
    def pos_count(self) -> np.ndarray:
        """(k,) int64 positive counts, as a host array of their own."""
        return self._pos.cpu().numpy().copy()

    # ------------------------------------------------------------------
    # Organization
    # ------------------------------------------------------------------

    def _reorganize_views(self, mask: np.ndarray):
        """Re-sort the scratch state of every view in `mask` from one
        shared `F @ W[mask].T` product. F itself never moves."""
        views = np.flatnonzero(mask)
        if views.size == 0:
            return
        t0 = self._clock()
        vd = torch.tensor(views, device=self.device)
        Z = (self.F @ self._Wd[vd].T - self._bd[vd]).T     # (m, n) fresh eps
        order = argsort_stable(Z, dim=1)
        eps = torch.gather(Z, 1, order)
        lab = classify(eps)
        self.perm[vd] = order
        self.inv_perm[vd] = torch.empty_like(order).scatter_(
            1, order, self._arange_n.expand(views.size, -1))
        self.eps_sorted[vd] = eps
        self.labels_sorted[vd] = lab
        self._pos[vd] = (lab == 1).sum(1)
        if self.buffer_cap:
            blo, bhi = hot_buffer_window(eps, self.buffer_cap)
            blo, bhi = torch.stack([blo, bhi]).cpu().numpy()
            self.buffer_lo[views], self.buffer_hi[views] = blo, bhi
            for j, v in enumerate(views if self.buffer_F is not None else ()):
                self.buffer_F[v, :bhi[j] - blo[j]] = self.F[
                    order[j, blo[j]:bhi[j]]]
        if self.store is not None:
            self._rewarm_store()
        self.W_stored[views] = self.W[views]
        self.b_stored[views] = self.b[views]
        self.lw[views] = 0.0
        self.hw[views] = 0.0
        self._waters_stale[views] = False
        self.pending[views] = False
        wall = (self._clock() - t0
                + self.touch_ns * 1e-9 * self.n * views.size)
        if hasattr(self, "S"):   # absent only during the free init round
            if self.cost_mode != "modeled":   # modeled: S stays pinned at 1.0
                self.S[views] = wall / views.size
            self.acc[views] = 0.0
            self.stats.reorgs += int(views.size)
            self.reorg_counts[views] += 1
            self.stats.reorg_seconds += wall
            for v in views:   # one view's share of the batched reorg
                self.cost.record_reorg(int(v), wall / views.size)

    def _rewarm_store(self):
        """Re-warm the pool along the new clustering order: pin the pages
        of every view's hot-buffer window, then prefetch pages of entities
        in the SHARED boundary-outward order (ascending min_v |eps_v|)
        until the budget is full — through an attached `Prefetcher`'s
        worker, else inline."""
        eps_entity = torch.gather(self.eps_sorted, 1, self.inv_perm)
        order = argsort_stable(eps_entity.abs().amin(0))
        hot = [self.perm[v, self.buffer_lo[v]:self.buffer_hi[v]]
               for v in range(self.k if self.buffer_cap else 0)]
        ids = torch.cat(hot + [order]).cpu().numpy()
        self.store.repin_rows(ids[:ids.size - self.n])
        self._eps_order = order = ids[ids.size - self.n:]
        self._eps_pos = None                  # built at the first hint
        pre = getattr(self.store, "prefetcher", None)
        if pre is not None:
            pre.enqueue(order)
        else:
            self.store.warm(order)

    def _hint_readahead(self, entity_id: int, window: int = 64):
        """Probe miss at shared eps-position p: enqueue the next `window`
        entities boundary-outward (the next pages). No-op without an
        attached prefetcher."""
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

    def _pool_row(self, entity_id: int):
        """The ONE shared touch of a row through the pool: (row as a host
        array, tier code), counting a cold read."""
        f, how = self.store.touch(entity_id)
        if how == "disk":
            self.disk_touches += 1            # cold page reads only
            self._hint_readahead(entity_id)
            return f.numpy(), TIER_DISK
        return f.numpy(), TIER_POOL

    def restore(self, perm: np.ndarray, eps_sorted: np.ndarray,
                labels_sorted: np.ndarray, **host):
        """Continue from another engine's state (see `core.convert`): the
        (k, n) per-view orders `perm` with their `eps_sorted` and
        `labels_sorted` (host arrays), and each host attribute named in
        `host`, set as given. `inv_perm` and the buffered rows are rebuilt
        from `perm` and the hot-buffer windows."""
        for name, value in host.items():
            setattr(self, name, value)
        dev = self.device
        self.perm = torch.tensor(perm, dtype=torch.int64, device=dev)
        self.inv_perm = torch.empty_like(self.perm).scatter_(
            1, self.perm, self._arange_n.expand(self.k, -1))
        self.eps_sorted = torch.tensor(eps_sorted, dtype=torch.float32,
                                       device=dev)
        self.labels_sorted = torch.tensor(labels_sorted, dtype=torch.int8,
                                          device=dev)
        self._pos = (self.labels_sorted == 1).sum(1)
        for v in range(self.k if self.buffer_F is not None else 0):
            lo, hi = int(self.buffer_lo[v]), int(self.buffer_hi[v])
            self.buffer_F[v, :hi - lo] = self.F[self.perm[v, lo:hi]]

    # ------------------------------------------------------------------
    # One maintenance round (all k views)
    # ------------------------------------------------------------------

    def apply_models(self, W: np.ndarray, b: np.ndarray):
        """The k views must reflect the stacked model (W, b): eager does the
        banded reclassify now; lazy/hybrid defer it to the next read that
        touches each view (per-view pending mask)."""
        self.W = np.asarray(W, np.float32).copy()
        self.b = np.asarray(b, np.float64).copy()
        self.stats.rounds += 1
        if self._defers:
            self.pending[:] = True
            self._waters_stale[:] = True
            self._waters_dirty = True
            if self.policy == "hybrid":
                # §3.5.2: relabels stay deferred, but SKIING still
                # reorganizes due views, charging the band fraction
                self._update_waters(np.arange(self.k))
                lo, hi = self._bands(np.arange(self.k))
                self.acc = skiing_charge(
                    self.acc, self.S * ((hi - lo) / max(1, self.n)))
                due = skiing_due(self.acc, self.alpha, self.S)
                self._reorganize_views(due)   # clears pending for due views
            return
        # SKIING, check-first (Fig. 7), independently per view.
        due = skiing_due(self.acc, self.alpha, self.S)
        self._reorganize_views(due)
        self._incremental_step(~due)

    def _update_waters(self, views: np.ndarray):
        """Vectorized Eq. 2 for the given views (monotone, idempotent)."""
        self.lw[views], self.hw[views] = waters_update(
            self.lw[views], self.hw[views], self.W[views], self.b[views],
            self.W_stored[views], self.b_stored[views], self.M, self.p)
        self._waters_stale[views] = False
        self._waters_dirty = bool(self._waters_stale.any())

    def _bands(self, views: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[lw, hw) of the given views as host arrays: one search of all k
        rows (one round trip), THE Lemma 3.1 partition."""
        lo, hi = band_bounds(self.eps_sorted, self.lw, self.hw)
        return lo[views], hi[views]

    def _relabel_bands(self, views: np.ndarray):
        """The shared banded-reclassify core: vectorized waters update
        (Eq. 2), per-view band location, ONE gather of the union band's
        feature rows and ONE matmul that classifies every view's band.
        Returns (lo, widths, total, wall) for the caller's cost model."""
        t0 = self._clock()
        self._update_waters(views)
        lo, hi = self._bands(views)
        widths = hi - lo
        total = int(widths.sum())
        if total > 0:
            j = np.flatnonzero(widths)            # views with a band
            meta = torch.tensor(np.stack([views[j], lo[j], widths[j], j]),
                                device=self.device)
            rep = dict(repeats=meta[2], output_size=total)
            first = torch.cumsum(meta[2], 0) - meta[2]
            vi = torch.repeat_interleave(meta[0], **rep)
            pos = (torch.arange(total, device=self.device)
                   + torch.repeat_interleave(meta[1] - first, **rep))
            col = torch.repeat_interleave(meta[3], **rep)
            band_ids = self.perm[vi, pos]
            # the union of the bands; the inverse is the reference's
            # searchsorted(uids, band_ids) lookup
            uids, at = torch.unique(band_ids, return_inverse=True)
            vd = torch.tensor(views, device=self.device)
            Z = self.F[uids] @ self._Wd[vd].T - self._bd[vd]
            new = classify(Z[at, col])
            old = self.labels_sorted[vi, pos]
            self.labels_sorted[vi, pos] = new
            self._pos.index_add_(0, vi, (new == 1).to(torch.int64)
                                 - (old == 1).to(torch.int64))
        wall = self._clock() - t0 + self.touch_ns * 1e-9 * total
        self.stats.tuples_reclassified += total
        self.stats.tuples_total_possible += self.n * views.size
        return lo, widths, total, wall

    def _incremental_step(self, mask: np.ndarray):
        views = np.flatnonzero(mask)
        if views.size == 0:
            return
        lo, widths, total, wall = self._relabel_bands(views)
        measured = wall * (widths / max(1, total))   # per-view wall share
        if self.cost_mode == "modeled":
            costs = self.S[views] * (widths / max(1, self.n))
        else:
            costs = measured
        for j, v in enumerate(views):
            self.cost.record_step(int(v), float(measured[j]), float(costs[j]))
        self.acc[views] = skiing_charge(self.acc[views], costs)
        self.stats.band_fraction_last = float(widths.mean()) / max(1, self.n)
        self.stats.incremental_seconds += wall

    def _catch_up(self, views: Optional[np.ndarray] = None):
        """Catch up the PENDING subset of `views` (default: every view).
        Views outside `views` keep deferring — per-view laziness — and the
        paper's §3.4 lazy waste is charged only to the views read now."""
        if not self._defers:
            return
        if views is None:
            todo = np.flatnonzero(self.pending)
        else:
            todo = np.asarray(views)[self.pending[np.asarray(views)]]
        if todo.size == 0:
            return
        lo, widths, total, wall = self._relabel_bands(todo)
        self.pending[todo] = False
        # §3.4 lazy waste per view: (N_R − N_+)/N_R of the tuples a lazy
        # All-Members read scans are wasted (read but not returned).
        n_read = np.maximum(1, self.n - lo)
        waste = np.maximum(0.0, (n_read - self.pos_count[todo]) / n_read)
        self.lazy_waste[todo] += waste
        measured = wall * (widths / max(1, total))   # per-view wall share
        if self.cost_mode == "modeled":
            costs = self.S[todo] * waste
        else:
            costs = measured
        for j, v in enumerate(todo):
            self.cost.record_step(int(v), float(measured[j]), float(costs[j]))
        self.acc[todo] = skiing_charge(self.acc[todo], costs)
        self.stats.incremental_seconds += wall
        due = np.zeros(self.k, bool)
        due[todo] = skiing_due(self.acc[todo], self.alpha, self.S[todo])
        self._reorganize_views(due)

    # ------------------------------------------------------------------
    # Reads
    # ------------------------------------------------------------------

    def all_members(self) -> np.ndarray:
        """Per-view positive-member counts, (k,) int64 — the All Members
        probe answered for every one-vs-all view at once."""
        self._catch_up()
        return self.pos_count

    def members(self, view: int) -> np.ndarray:
        self._catch_up(np.array([view]))
        return self.perm[view, self.labels_sorted[view] == 1].cpu().numpy()

    def label(self, view: int, entity_id: int) -> int:
        """Hot read of ONE view: catches up only that view; the other k−1
        pending views keep deferring."""
        self._catch_up(np.array([view]))
        return int(self.labels_sorted[view, self.inv_perm[view, entity_id]])

    def labels_of(self, entity_id: int) -> np.ndarray:
        """All k view labels of one entity, (k,) int8 (one eps-map probe
        per view; no feature access). Catches up all views."""
        self._catch_up()
        pos = self.inv_perm[:, entity_id]
        return self.labels_sorted[self._arange_k, pos].cpu().numpy()

    def band_fractions(self) -> np.ndarray:
        self._catch_up()   # stale waters would report pre-catch-up bands
        lo, hi = self._bands(np.arange(self.k))
        return (hi - lo) / max(1, self.n)

    # ------------------------------------------------------------------
    # Hybrid single-entity reads (paper §3.5.2, Fig. 8) — per-view tier
    # ------------------------------------------------------------------

    def _probe(self, view: Optional[int], entity_id: int):
        """The eps-map probe of `entity_id` in one view (all k where `view`
        is None): THE Lemma 3.1 point partition of its stored eps against
        the float64 waters, and its positions, as host arrays (one round
        trip)."""
        if view is None:
            pos = self.inv_perm[:, entity_id]
            e = self.eps_sorted[self._arange_k, pos]
            sel = slice(None)
        else:
            pos = self.inv_perm[view, entity_id].reshape(1)
            e = self.eps_sorted[view, pos]
            sel = slice(view, view + 1)
        pos, e = torch.stack([pos.to(torch.float64),
                              e.to(torch.float64)]).cpu().numpy()
        t = probe_partition(torch.from_numpy(e),
                            torch.from_numpy(self.lw[sel]),
                            torch.from_numpy(self.hw[sel])).numpy()
        return t, pos.astype(np.int64)

    def hybrid_label(self, view: int, entity_id: int) -> Tuple[int, str]:
        """One view's §3.5.2 read: eps-map probe -> waters short-circuit ->
        hot buffer -> "disk" (the shared F row; over a storage tier the
        pool: "pool" or "disk"). Exact under every policy: a pending model
        needs only the monotone waters update."""
        if self._waters_dirty:
            self._update_waters(np.flatnonzero(self._waters_stale))
        t, pos = self._probe(view, entity_id)
        t, pos = int(t[0]), int(pos[0])
        if t != 0:
            self.hybrid_hits[TIER_WATER] += 1
            return t, "water"
        in_buf = (self.buffer_cap
                  and self.buffer_lo[view] <= pos < self.buffer_hi[view])
        if self.store is not None:
            # a hot-buffer row is a resident (pinned) pool page; a window
            # wider than the budget leaves its tail unpinned, and those
            # rows fall through to the pool/disk tiers
            if in_buf and self.store.resident(entity_id):
                f, tier = self.store.get_row(entity_id).numpy(), TIER_BUFFER
            else:
                f, tier = self._pool_row(entity_id)
            self.hybrid_hits[tier] += 1
            z = f @ self.W[view] - np.float32(self.b[view])
            return int(host_classify(z)), PROBE_TIERS[tier]
        if in_buf:
            f = self.buffer_F[view, pos - self.buffer_lo[view]]
            how, tier = "buffer", TIER_BUFFER
        else:
            f = self.F[entity_id]
            self.disk_touches += 1     # charged as disk_touches * touch_ns
            how, tier = "disk", TIER_DISK
        self.hybrid_hits[tier] += 1
        return int(classify(torch.dot(f, self._Wd[view])
                            - self._bd[view])), how

    def hybrid_labels_of(self, entity_id: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """All k views' §3.5.2 reads at once: ((k,) int8 labels, (k,) int8
        tier codes indexing HYBRID_TIERS). The views that miss water AND
        buffer share ONE `F[entity_id]` touch (one product against their
        stacked models) instead of k feature reads."""
        if self._waters_dirty:
            self._update_waters(np.flatnonzero(self._waters_stale))
        t, pos = self._probe(None, entity_id)
        miss = t == 0
        if not miss.any():                 # every view water-short-circuited
            self.hybrid_hits[TIER_WATER] += self.k
            return t.copy(), np.zeros(self.k, np.int8)
        labels = t.copy()
        how = np.zeros(self.k, np.int8)
        in_buf = (miss & (self.buffer_lo <= pos) & (pos < self.buffer_hi)
                  if self.buffer_cap else np.zeros(self.k, bool))
        if self.store is not None:
            self._pool_labels(entity_id, miss, in_buf, labels, how)
        else:
            z = []
            bviews = np.flatnonzero(in_buf)
            if bviews.size:
                bv = torch.tensor(bviews, device=self.device)
                slot = torch.tensor(pos[bviews] - self.buffer_lo[bviews],
                                    device=self.device)
                z.append((self.buffer_F[bv, slot] * self._Wd[bv]).sum(1)
                         - self._bd[bv])
                how[bviews] = TIER_BUFFER
            dviews = np.flatnonzero(miss & ~in_buf)
            if dviews.size:
                dv = torch.tensor(dviews, device=self.device)
                z.append(self._Wd[dv] @ self.F[entity_id] - self._bd[dv])
                how[dviews] = TIER_DISK
                self.disk_touches += 1     # the ONE shared feature touch
            labels[np.concatenate([bviews, dviews])] = classify(
                torch.cat(z)).cpu().numpy()
        # every view lands in one tier (water: the views how leaves at 0)
        self.hybrid_hits += np.bincount(how, minlength=len(PROBE_TIERS))
        return labels, how

    def _pool_labels(self, entity_id: int, miss, in_buf, labels, how):
        """The probe-missing views of `hybrid_labels_of` over the storage
        tier, classified on the host into `labels` / `how`: when the row's
        page is resident, ONE pinned-page read serves every buffered view;
        ONE shared touch of the pool serves the rest."""
        if in_buf.any() and self.store.resident(entity_id):
            bviews = np.flatnonzero(in_buf)
            f = self.store.get_row(entity_id).numpy()
            z = self.W[bviews] @ f - self.b[bviews].astype(np.float32)
            labels[bviews] = host_classify(z)
            how[bviews] = TIER_BUFFER
            miss = miss & ~in_buf
        dviews = np.flatnonzero(miss)
        if dviews.size:
            f, code = self._pool_row(entity_id)
            z = self.W[dviews] @ f - self.b[dviews].astype(np.float32)
            labels[dviews] = host_classify(z)
            how[dviews] = code

    # ------------------------------------------------------------------

    def check_consistent(self) -> bool:
        """Golden invariant, per view: maintained labels == from-scratch
        relabel of the shared table under that view's current model."""
        self._catch_up()
        Z = (self.F @ self._Wd.T - self._bd).T
        truth = classify(torch.gather(Z, 1, self.perm))
        return bool(torch.equal(truth, self.labels_sorted))
