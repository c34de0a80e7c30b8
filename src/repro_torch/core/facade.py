"""`EngineFacade` — ONE serving interface over the engine shells, the
interface the SQL front end drives; counterpart of `repro.core.facade`.

  * `SingleViewFacade`  — `ClassificationView` over `HazyEngine` (k = 1);
  * `DerivedViewFacade` — a single view over another view's margin column;
  * `MultiViewFacade`   — `MulticlassView` over the vectorized
                          `MultiViewEngine` (k one-vs-all views, ONE table);
  * `ShardedFacade`     — `ShardedMultiViewHazy` (a shared clustering order
                          and the multi-view band kernel).

Each engine's state lives on its device; the facades keep the host numpy
copy of the features for SGD and for margins. One group commit is
`insert_examples` (SGD per example, then ONE maintenance round); point
reads report which §3.5.2 tier answered them (`tier_hits`). A view over a
storage tier reports its pool (`storage_stats`, `prefetcher_stats`) and
hands its prospective band to the pool's prefetcher (`prefetch_band`).

`top_margins` is exact under model drift: stored eps bound the current
margin to z ∈ [eps + lw, eps + hw] (Eq. 2), so the candidate set only needs
stored eps ≥ c − (hw − lw), c being the limit-th largest stored eps.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import (PROBE_TIERS, argsort_stable,
                                     band_bounds, covering_windows,
                                     probe_partition, waters_update)
from repro_torch.core.multiclass import MulticlassView, sgd_all_views
from repro_torch.core.sharded import (ShardedMultiViewHazy,
                                      ShardedMultiViewState)
from repro_torch.core.view import ClassificationView
from repro_torch.core.waters import holder_M

# "pool" = probe miss answered by a resident page of a storage tier; "disk"
# = the feature table was touched. Facades without a storage tier keep the
# pool counter at zero.
TIERS = ("water", "buffer", "pool", "disk", "map")


def _new_tier_hits() -> Dict[str, int]:
    return {t: 0 for t in TIERS}


class EngineFacade:
    """Shared contract + shared helpers; subclasses bind one engine shell."""

    num_views: int
    n: int
    d: int
    policy: str
    supports_delete = False     # footnote-2 retrain; single-view only

    def __init__(self):
        self.tier_hits = _new_tier_hits()
        # consumed only by the footnote-2 retrain
        self.example_log: List[Tuple[int, float]] = []

    # -- updates -------------------------------------------------------
    def insert_examples(self, ids: Sequence[int], labels: Sequence[float]):
        raise NotImplementedError

    def force_round(self):
        """UPDATE MODEL: one maintenance round under the current model."""
        raise NotImplementedError

    def delete_examples(self, entity_id: int) -> int:
        raise NotImplementedError(
            "DELETE retrains from scratch (paper footnote 2); only "
            "single-view views support it")

    # -- reads ---------------------------------------------------------
    def label(self, entity_id: int, view: int = 0) -> int:
        raise NotImplementedError

    def point_label(self, entity_id: int, view: int = 0) -> Tuple[int, str]:
        raise NotImplementedError

    def point_labels_of(self, entity_id: int) -> Tuple[np.ndarray, List[str]]:
        raise NotImplementedError

    def labels_of(self, entity_id: int) -> np.ndarray:
        raise NotImplementedError

    def counts(self) -> np.ndarray:
        raise NotImplementedError

    def members(self, view: int = 0, positive: bool = True) -> np.ndarray:
        raise NotImplementedError

    def predict(self, entity_id: int) -> int:
        raise NotImplementedError

    def margin(self, entity_id: int, view: int = 0) -> float:
        """Current-model margin of one entity (touches its feature row)."""
        raise NotImplementedError

    def margins_of(self, ids: Sequence[int],
                   rows: Optional[np.ndarray] = None,
                   view: int = 0) -> np.ndarray:
        """Current-model margins of `ids`, as a float32 `(len(ids), 1)`
        column; `rows` overrides the facade's own feature lookup."""
        raise NotImplementedError

    # -- state the planner reads --------------------------------------
    def waters(self) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def pending(self) -> np.ndarray:
        raise NotImplementedError

    def band_info(self, view: int = 0) -> Tuple[int, int, int]:
        """(band width, certainly-positive count, n) under PROSPECTIVE
        waters (what the next read would see) — pure, never mutates."""
        raise NotImplementedError

    @property
    def disk_touches(self) -> int:
        raise NotImplementedError

    def storage_stats(self) -> Optional[dict]:
        """Buffer-pool snapshot of the view's storage tier
        (`BufferPool.stats()`), or None when the feature table is fully in
        memory."""
        return None

    def prefetcher_stats(self) -> Optional[dict]:
        """Background prefetcher counters, or None without one."""
        eng = getattr(self, "engine", None)
        pre = getattr(getattr(eng, "store", None), "prefetcher", None)
        return pre.stats() if pre is not None else None

    def cost_stats(self) -> Optional[List[dict]]:
        """Per-view modeled-vs-measured SKIING cost rows, or None when the
        engine records no cost telemetry."""
        return None

    def telemetry_snapshot(self) -> dict:
        """Collector payload for a metrics registry: tier hits + storage +
        prefetcher + per-view cost."""
        out = {
            "policy": self.policy,
            "num_views": int(self.num_views),
            "tier_hits": dict(self.tier_hits),
            "disk_touches": int(self.disk_touches),
        }
        st = self.storage_stats()
        if st is not None:
            out["storage"] = st
        pre = self.prefetcher_stats()
        if pre is not None:
            out["prefetcher"] = pre
        cost = self.cost_stats()
        if cost is not None:
            out["cost"] = cost
        return out

    def prefetch_band(self, view: int = 0) -> int:
        """Hand the view's PROSPECTIVE band — the entities a label scan is
        about to classify against the current model — to the storage
        tier's background prefetcher, boundary-outward. Advisory: returns
        the number of entities scheduled, 0 without a storage tier, a
        prefetcher or a band. Never blocks on I/O."""
        return 0

    @staticmethod
    def _prefetch_band_row(pre, eps_sorted, perm, lw, hw) -> int:
        """`prefetch_band` of one eps-sorted row (device tensors) at the
        prospective waters: its band's ids, smallest |eps| first (the rows
        a scan's probes miss soonest), to the prefetcher, streaming."""
        lo, hi = (int(x) for x in band_bounds(eps_sorted, lw, hw))
        if hi <= lo:
            return 0
        band = eps_sorted[lo:hi]
        ids = perm[lo:hi][argsort_stable(band.abs())].cpu().numpy()
        pre.enqueue(ids, evict=True)
        return int(ids.size)

    def top_margins(self, view: int = 0, limit: int = 10,
                    descending: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Top-`limit` entities of `view` by CURRENT-model margin, exact via
        the Eq. 2 candidate slack; returns (ids, margins, tuples_touched)."""
        raise NotImplementedError

    # shared Eq.2-slack candidate selection over one stored-eps-sorted row
    def _topk_from_sorted(self, eps_sorted, perm, lw, hw, limit, descending,
                          margin_of_ids):
        n = eps_sorted.shape[0]
        limit = max(1, min(int(limit), n))
        slack = max(0.0, float(hw) - float(lw))
        if descending:
            c = eps_sorted[n - limit]
            lo = int(np.searchsorted(eps_sorted, c - slack, side="left"))
            cand = np.arange(lo, n)
        else:
            c = eps_sorted[limit - 1]
            hi = int(np.searchsorted(eps_sorted, c + slack, side="right"))
            cand = np.arange(0, hi)
        ids = np.asarray(perm)[cand]
        z = margin_of_ids(ids)
        order = np.argsort(-z if descending else z, kind="stable")[:limit]
        return ids[order], z[order], int(cand.size)


class SingleViewFacade(EngineFacade):
    """k = 1: `ClassificationView` over `HazyEngine`."""

    num_views = 1
    supports_delete = True

    def __init__(self, view: ClassificationView):
        super().__init__()
        self.view = view
        self.n, self.d = view.F.shape
        self.policy = view.engine.policy

    @property
    def engine(self):
        return self.view.engine

    def insert_examples(self, ids, labels):
        self.example_log.extend(
            (int(i), float(y)) for i, y in zip(ids, labels))
        self.view.insert_examples(list(ids), list(labels), batched=True)

    def force_round(self):
        self.view.engine.apply_model(self.view.model)

    def delete_examples(self, entity_id: int) -> int:
        """Footnote 2: drop every example of this entity and retrain
        non-incrementally (zero model -> replay the surviving stream)."""
        keep = [(i, y) for i, y in self.example_log if i != int(entity_id)]
        dropped = len(self.example_log) - len(keep)
        self.example_log = keep
        self.view.examples = [(self.view.F[i], y) for i, y in keep]
        self.view.retrain_from_scratch()
        return dropped

    def label(self, entity_id, view=0):
        return int(self.view.engine.label(int(entity_id)))

    def point_label(self, entity_id, view=0):
        eng = self.view.engine
        if self.policy == "hybrid":
            lab, how = eng.hybrid_label(int(entity_id))
        else:
            lab, how = eng.label(int(entity_id)), "map"
        self.tier_hits[how] += 1
        return int(lab), how

    def point_labels_of(self, entity_id):
        lab, how = self.point_label(entity_id)
        return np.array([lab], np.int8), [how]

    def labels_of(self, entity_id):
        return np.array([self.label(entity_id)], np.int8)

    def counts(self):
        return np.array([self.view.engine.all_members()], np.int64)

    def members(self, view=0, positive=True):
        eng = self.view.engine
        pos = eng.members()          # catches up under lazy/hybrid
        if positive:
            return pos
        return eng.perm[eng.labels_sorted == -1].cpu().numpy()

    def predict(self, entity_id):
        return self.point_label(entity_id)[0]

    def margin(self, entity_id, view=0):
        m = self.view.model
        return float(self.view.F[int(entity_id)] @ m.w - m.b)

    def margins_of(self, ids, rows=None, view=0):
        m = self.view.model
        if rows is None:
            X = self.view.F[np.asarray(ids, np.int64)]
        else:
            X = np.asarray(rows, np.float32)
        return (X @ m.w - m.b).astype(np.float32).reshape(len(X), 1)

    def waters(self):
        w = self.view.engine.waters
        return (np.array([w.lw], np.float64), np.array([w.hw], np.float64))

    def pending(self):
        return np.array([self.view.engine._pending is not None])

    def _prospective_waters(self):
        """Eq. 2 waters covering any PENDING model too — pure, not
        committed. Under lazy/hybrid a deferred model has not updated the
        engine's waters yet; every bound derived from stored eps (band
        width, top-k candidate slack) must use these, not the stale pair."""
        eng = self.view.engine
        lw, hw = eng.waters.lw, eng.waters.hw
        if eng._pending is not None:
            lw, hw = waters_update(lw, hw, eng.model.w, eng.model.b,
                                   eng.stored.w, eng.stored.b, eng.M,
                                   eng.waters.p)
        return float(lw), float(hw)

    def band_info(self, view=0):
        eng = self.view.engine
        lw, hw = self._prospective_waters()
        lo, hi = band_bounds(eng.eps_sorted, lw, hw)
        return int(hi - lo), int(self.n - hi), self.n

    @property
    def disk_touches(self):
        return int(self.view.engine.disk_touches)

    def storage_stats(self):
        store = getattr(self.view.engine, "store", None)
        return store.stats() if store is not None else None

    def prefetch_band(self, view=0):
        eng = self.view.engine
        pre = getattr(getattr(eng, "store", None), "prefetcher", None)
        if pre is None:
            return 0
        return self._prefetch_band_row(pre, eng.eps_sorted, eng.perm,
                                       *self._prospective_waters())

    def top_margins(self, view=0, limit=10, descending=True):
        eng = self.view.engine
        m = self.view.model
        lw, hw = self._prospective_waters()   # pending drift widens slack
        return self._topk_from_sorted(
            eng.eps_sorted.cpu().numpy(), eng.perm.cpu().numpy(), lw, hw,
            limit, descending,
            lambda ids: np.asarray(self.view.F[ids] @ m.w - m.b, np.float64))

    def cost_stats(self):
        eng = self.view.engine
        row = eng.cost.snapshot(0)
        row.update(view=0, policy=self.policy, cost_mode=eng.cost_mode,
                   S_model=float(eng.skiing.S), alpha=float(eng.skiing.alpha),
                   acc=float(eng.skiing.a),
                   reorgs_modeled=int(eng.skiing.reorgs))
        return [row]


class DerivedViewFacade(SingleViewFacade):
    """A classification view whose feature table is another view's margin
    column (views-over-views). The wrapped `ClassificationView` is an
    ordinary hazy k=1 view over an `(n, 1)` float32 matrix; this subclass
    adds the two hooks the freshness scheduler drives:

      * `insert_examples(..., features=)` trains on inputs PINNED at the
        parent's emission time, so the model trajectory is independent of
        when the refresh runs (it also skips the footnote-2 example log —
        DELETE cannot replay through a derived chain and is rejected
        upstream);
      * `refresh_features(F_new)` re-points the view at the parent's
        current margin column (a full pull — cheap at `(n, 1)`)."""

    supports_delete = False

    def __init__(self, view: ClassificationView, source: str):
        super().__init__(view)
        self.source = source               # the parent view's name

    def insert_examples(self, ids, labels, features=None):
        self.view.insert_examples(list(ids), list(labels), batched=True,
                                  features=features)

    def delete_examples(self, entity_id: int) -> int:
        raise NotImplementedError(
            "DELETE cannot replay through a derived view")

    def refresh_features(self, F_new: np.ndarray) -> None:
        self.view.refresh_features(np.asarray(F_new, np.float32))
        self.n, self.d = self.view.F.shape


class MultiViewFacade(EngineFacade):
    """k one-vs-all views: `MulticlassView` over `MultiViewEngine`."""

    def __init__(self, mc: MulticlassView):
        super().__init__()
        assert mc.vectorized, "MultiViewFacade requires the vectorized engine"
        self.mc = mc
        self.num_views = mc.k
        self.n, self.d = mc.F.shape
        self.policy = mc.engine.policy

    @property
    def engine(self):
        return self.mc.engine

    def insert_examples(self, ids, labels):
        # no example_log here: only the footnote-2 retrain (single-view
        # DELETE) consumes it, and k-view facades don't support that —
        # logging would just grow memory forever on a long insert stream
        self.mc.insert_examples([int(i) for i in ids],
                                [int(c) for c in labels])

    def force_round(self):
        self.mc.engine.apply_models(self.mc.W, self.mc.b)

    def label(self, entity_id, view=0):
        return int(self.mc.engine.label(int(view), int(entity_id)))

    def point_label(self, entity_id, view=0):
        eng = self.mc.engine
        if self.policy == "hybrid":
            lab, how = eng.hybrid_label(int(view), int(entity_id))
        else:
            lab, how = eng.label(int(view), int(entity_id)), "map"
        self.tier_hits[how] += 1
        return int(lab), how

    def point_labels_of(self, entity_id):
        eng = self.mc.engine
        if self.policy == "hybrid":
            labels, codes = eng.hybrid_labels_of(int(entity_id))
            hows = [PROBE_TIERS[c] for c in codes]
        else:
            labels = eng.labels_of(int(entity_id))
            hows = ["map"] * self.num_views
        for h in hows:
            self.tier_hits[h] += 1
        return labels, hows

    def labels_of(self, entity_id):
        return self.mc.engine.labels_of(int(entity_id))

    def counts(self):
        return self.mc.engine.all_members().astype(np.int64)

    def members(self, view=0, positive=True):
        eng = self.mc.engine
        pos = eng.members(int(view))     # per-view lazy catch-up
        if positive:
            return pos
        return eng.perm[view, eng.labels_sorted[view] == -1].cpu().numpy()

    def predict(self, entity_id):
        if self.policy == "hybrid":
            return int(self.mc.predict_via_views(int(entity_id)))
        return int(self.mc.predict(int(entity_id)))

    def margin(self, entity_id, view=0):
        return float(self.mc.F[int(entity_id)] @ self.mc.W[view]
                     - self.mc.b[view])

    def waters(self):
        eng = self.mc.engine
        return eng.lw.copy(), eng.hw.copy()

    def pending(self):
        return self.mc.engine.pending.copy()

    def _prospective_waters(self, v: int):
        """Per-view Eq. 2 waters covering any pending model — pure (see
        `SingleViewFacade._prospective_waters`)."""
        eng = self.mc.engine
        lw, hw = float(eng.lw[v]), float(eng.hw[v])
        if eng._waters_stale[v]:
            lw, hw = waters_update(lw, hw, eng.W[v], eng.b[v],
                                   eng.W_stored[v], eng.b_stored[v],
                                   eng.M, eng.p)
        return float(lw), float(hw)

    def band_info(self, view=0):
        eng = self.mc.engine
        v = int(view)
        lw, hw = self._prospective_waters(v)
        lo, hi = band_bounds(eng.eps_sorted[v], lw, hw)
        return int(hi - lo), int(self.n - hi), self.n

    @property
    def disk_touches(self):
        return int(self.mc.engine.disk_touches)

    def storage_stats(self):
        store = getattr(self.mc.engine, "store", None)
        return store.stats() if store is not None else None

    def prefetch_band(self, view=0):
        eng = self.mc.engine
        pre = getattr(getattr(eng, "store", None), "prefetcher", None)
        if pre is None:
            return 0
        v = int(view)
        return self._prefetch_band_row(pre, eng.eps_sorted[v], eng.perm[v],
                                       *self._prospective_waters(v))

    def top_margins(self, view=0, limit=10, descending=True):
        eng = self.mc.engine
        v = int(view)
        lw, hw = self._prospective_waters(v)  # pending drift widens slack
        return self._topk_from_sorted(
            eng.eps_sorted[v].cpu().numpy(), eng.perm[v].cpu().numpy(), lw,
            hw, limit, descending,
            lambda ids: np.asarray(
                self.mc.F[ids] @ eng.W[v] - eng.b[v], np.float64))

    def cost_stats(self):
        eng = self.mc.engine
        out = []
        for v in range(self.num_views):
            row = eng.cost.snapshot(v)
            row.update(view=v, policy=self.policy, cost_mode=eng.cost_mode,
                       S_model=float(eng.S[v]), alpha=float(eng.alpha),
                       acc=float(eng.acc[v]),
                       reorgs_modeled=int(eng.reorg_counts[v]),
                       lazy_waste=float(eng.lazy_waste[v]))
            out.append(row)
        return out


class ShardedFacade(EngineFacade):
    """`ShardedMultiViewHazy`: device-resident shared clustering order,
    union-band relabels through the CUDA kernel, host-side stacked SGD.
    Wraps an existing device `state` (`make_sharded_facade` builds a fresh
    one; `convert.from_reference` carries one over) and the host models
    `W` (k, d) f32 / `b` (k,) f64 it reflects (zero by default)."""

    policy = "eager"

    def __init__(self, driver: ShardedMultiViewHazy, features: np.ndarray,
                 state: ShardedMultiViewState, *, lr: float = 0.1,
                 l2: float = 1e-4, W: Optional[np.ndarray] = None,
                 b: Optional[np.ndarray] = None):
        super().__init__()
        self.driver = driver
        self.F = np.ascontiguousarray(features, np.float32)
        self.n, self.d = self.F.shape
        self.num_views = driver.k
        self.lr, self.l2 = lr, l2
        self.W = (np.zeros((driver.k, self.d), np.float32) if W is None
                  else np.array(W, np.float32))
        self.b = (np.zeros(driver.k, np.float64) if b is None
                  else np.array(b, np.float64))
        self.state = state
        self._disk = 0

    def insert_examples(self, ids, labels):
        for i, c in zip(ids, labels):
            self.W, self.b = sgd_all_views(self.W, self.b, self.F[int(i)],
                                           int(c), lr=self.lr, l2=self.l2)
        self.state = self.driver.apply_models(self.state, self.W, self.b)

    def force_round(self):
        self.state = self.driver.apply_models(self.state, self.W, self.b)

    def point_labels_of(self, entity_id):
        labels, resolved = self.driver.hybrid_labels_of(
            self.state, self.W, self.b, int(entity_id))
        hows = ["water" if r else "disk" for r in resolved]
        if not bool(np.asarray(resolved).all()):
            self._disk += 1            # ONE shared feature-row gather
        for h in hows:
            self.tier_hits[h] += 1
        return labels, hows

    def point_label(self, entity_id, view=0):
        labels, hows = self.point_labels_of(entity_id)
        return int(labels[int(view)]), hows[int(view)]

    def labels_of(self, entity_id):
        return self.driver.labels_of(self.state, int(entity_id))

    def label(self, entity_id, view=0):
        return int(self.labels_of(entity_id)[int(view)])

    def counts(self):
        return self.driver.all_members(self.state).astype(np.int64)

    def members(self, view=0, positive=True):
        want = 1 if positive else -1
        ids = self.state.gids[self.state.labels[int(view)] == want]
        return torch.sort(ids).values.cpu().numpy()

    def predict(self, entity_id):
        labels, _ = self.point_labels_of(entity_id)
        pos = np.flatnonzero(labels == 1)
        if pos.size == 1:
            return int(pos[0])
        f = self.F[int(entity_id)]
        cand = pos if pos.size > 1 else np.arange(self.num_views)
        z = self.W[cand] @ f - self.b[cand].astype(np.float32)
        return int(cand[np.argmax(z)])

    def margin(self, entity_id, view=0):
        return float(self.F[int(entity_id)] @ self.W[view] - self.b[view])

    def waters(self):
        return self.driver.lw.copy(), self.driver.hw.copy()

    def pending(self):
        return np.zeros(self.num_views, bool)      # eager: nothing deferred

    def band_info(self, view=0):
        eps = self.state.eps                       # (k, n), SHARED order
        dev = eps.device
        lw = torch.tensor(self.driver.lw.astype(np.float32), device=dev)
        hw = torch.tensor(self.driver.hw.astype(np.float32), device=dev)
        _, _, width = covering_windows(eps, lw, hw)
        v = int(view)
        # certainly-positive == probe tier +1 (THE Lemma 3.1 partition)
        certain_pos = int((probe_partition(eps[v], lw[v], hw[v]) == 1).sum())
        return int(width[v]), certain_pos, self.n

    @property
    def disk_touches(self):
        return self._disk

    def top_margins(self, view=0, limit=10, descending=True):
        v = int(view)
        eps = self.state.eps[v].cpu().numpy()      # stored-model margins
        gids = self.state.gids.cpu().numpy()
        order = np.argsort(eps, kind="stable")
        return self._topk_from_sorted(
            eps[order], gids[order], self.driver.lw[v], self.driver.hw[v],
            limit, descending,
            lambda ids: np.asarray(
                self.F[ids] @ self.W[v] - self.b[v], np.float64))


def make_sharded_facade(features: np.ndarray, k: int, *, p: float = 2.0,
                        q: float = 2.0, lr: float = 0.1, l2: float = 1e-4,
                        alpha: float = 1.0, cap_frac: float = 0.5,
                        device=None) -> ShardedFacade:
    """Build a `ShardedFacade` over a fresh device state. `device=None`
    means the GPU and raises without one; tests pass `device="cpu"`."""
    F = np.ascontiguousarray(features, np.float32)
    driver = ShardedMultiViewHazy(
        n=F.shape[0], d=F.shape[1], k=int(k), M=holder_M(F, q), p=p,
        alpha=alpha, cap_frac=cap_frac, device=device)
    return ShardedFacade(driver, F, driver.init_state(F), lr=lr, l2=l2)
