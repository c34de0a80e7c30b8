"""Multiclass classification via one-versus-all binary views (paper App.
B.5.4 / C.3), counterpart of `repro.core.multiclass`.

`sgd_all_views` is the stacked one-vs-all SGD step in host numpy, bit for
bit the reference's arithmetic: every k-view facade trains through it.
`MulticlassView` has the reference's two execution paths over one API —
vectorized (one `MultiViewEngine`, one maintenance round per batch over
the union band) and the per-class loop (k `HazyEngine`s or
`NaiveEngine`s) — with training on the host and the engines' state on the
device.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.hazy import HazyEngine, NaiveEngine
from repro_torch.core.linear_model import LinearModel, sgd_step, zero_model
from repro_torch.core.multiview import MultiViewEngine
from repro_torch.device import resolve_device
from repro_torch.kernels.eps_affine.ops import eps_affine


def sgd_all_views(W: np.ndarray, b: np.ndarray, f: np.ndarray, cls: int, *,
                  lr: float, l2: float):
    """One training example against all k one-vs-all hinge models at once
    (f32 margins and weights, bias kept in f64), bit-for-bit the
    reference's arithmetic."""
    k = W.shape[0]
    y = np.where(np.arange(k) == cls, 1.0, -1.0)
    z = W @ f - b.astype(np.float32)          # (k,) f32 margins
    g = np.where(y * z.astype(np.float64) < 1.0, -y, 0.0)
    W = W * (1.0 - lr * l2)
    W -= (lr * g).astype(np.float32)[:, None] * f[None, :]
    return W, b - lr * (-g)


class MulticlassView:
    """k one-vs-all views of one feature table: training (stacked SGD on
    the host f32 table) and reads, over one `MultiViewEngine`
    (`vectorized`, the default) or one `HazyEngine` / `NaiveEngine` a
    class. The engines hold the device copies; `device=None` means the
    GPU."""

    def __init__(self, features: np.ndarray, num_classes: int, *,
                 engine: str = "hazy", policy: str = "eager", lr: float = 0.1,
                 l2: float = 1e-4, alpha: float = 1.0,
                 p: float = float("inf"), q: float = 1.0,
                 cost_mode: str = "measured", touch_ns: float = 0.0,
                 buffer_frac: float = 0.0, vectorized: bool = True,
                 store=None, device=None):
        self.F = np.asarray(features, np.float32)
        self.k = num_classes
        self.lr, self.l2 = lr, l2
        if policy == "hybrid" and not buffer_frac:
            buffer_frac = 0.01            # paper §4.2 default: 1% in memory
        self.vectorized = bool(vectorized) and engine == "hazy"
        if store is not None and not self.vectorized:
            raise ValueError("the storage tier (store=) requires the "
                             "vectorized MultiViewEngine")
        if self.vectorized:
            self.W = np.zeros((num_classes, self.F.shape[1]), np.float32)
            self.b = np.zeros(num_classes, np.float64)
            self.engine = MultiViewEngine(self.F, num_classes, p=p, q=q,
                                          alpha=alpha, policy=policy,
                                          cost_mode=cost_mode,
                                          touch_ns=touch_ns,
                                          buffer_frac=buffer_frac,
                                          store=store, device=device)
            self.engines = None
        else:
            self._models = [zero_model(self.F.shape[1])
                            for _ in range(num_classes)]
            # one device copy of F, shared by the k engines
            shared = dict(device=device, features_on_device=torch.tensor(
                np.ascontiguousarray(self.F), device=resolve_device(device)))
            if engine == "hazy":
                self.engines = [HazyEngine(self.F, p=p, q=q, alpha=alpha,
                                           policy=policy, cost_mode=cost_mode,
                                           touch_ns=touch_ns,
                                           buffer_frac=buffer_frac, **shared)
                                for _ in range(num_classes)]
            else:
                # NaiveEngine has no hybrid tier; lazy is the closest policy
                # (it too classifies on read against the current model).
                self.engines = [NaiveEngine(
                    self.F, policy="lazy" if policy == "hybrid" else policy,
                    touch_ns=touch_ns, **shared)
                    for _ in range(num_classes)]
            self.engine = None

    # ------------------------------------------------------------------
    # Model state
    # ------------------------------------------------------------------

    @property
    def models(self) -> List[LinearModel]:
        if self.vectorized:
            return [LinearModel(self.W[c].copy(), float(self.b[c]))
                    for c in range(self.k)]
        return self._models

    def _sgd_all_views(self, f: np.ndarray, cls: int):
        self.W, self.b = sgd_all_views(self.W, self.b, f, cls,
                                       lr=self.lr, l2=self.l2)

    # ------------------------------------------------------------------
    # Updates
    # ------------------------------------------------------------------

    def insert_example(self, entity_id: int, cls: int):
        f = self.F[entity_id]
        if self.vectorized:
            self._sgd_all_views(f, cls)
            self.engine.apply_models(self.W, self.b)
            return
        for c in range(self.k):
            y = 1.0 if c == cls else -1.0
            self._models[c] = sgd_step(self._models[c], f, y, lr=self.lr,
                                       l2=self.l2, method="svm")
            self.engines[c].apply_model(self._models[c])

    def insert_examples(self, entity_ids: Sequence[int], classes: Sequence[int]):
        """Batched fast path: per-example SGD (identical model trajectory),
        ONE maintenance round for the whole batch."""
        if not self.vectorized:
            for i, c in zip(entity_ids, classes):
                self.insert_example(int(i), int(c))
            return
        for i, c in zip(entity_ids, classes):
            self._sgd_all_views(self.F[int(i)], int(c))
        self.engine.apply_models(self.W, self.b)

    # ------------------------------------------------------------------
    # Reads
    # ------------------------------------------------------------------

    def predict(self, entity_id: int) -> int:
        """argmax over per-class margins (ties to one-vs-all labels)."""
        f = self.F[entity_id]
        if self.vectorized:
            return int(np.argmax(self.W @ f - self.b.astype(np.float32)))
        scores = [f @ m.w - m.b for m in self._models]
        return int(np.argmax(scores))

    def predict_batch(self, entity_ids: Sequence[int]) -> np.ndarray:
        ids = np.asarray(entity_ids, np.int64)
        if self.vectorized:
            scores = self.F[ids] @ self.W.T - self.b.astype(np.float32)
        else:
            W = np.stack([m.w for m in self._models])
            b = np.array([m.b for m in self._models], np.float32)
            scores = self.F[ids] @ W.T - b
        return np.argmax(scores, axis=1)

    def class_counts(self) -> List[int]:
        if self.vectorized:
            return [int(c) for c in self.engine.all_members()]
        return [e.all_members() for e in self.engines]

    def view_labels(self, entity_id: int) -> np.ndarray:
        """±1 membership of one entity in each of the k views."""
        if self.vectorized:
            return self.engine.labels_of(entity_id)
        return np.array([e.label(entity_id) for e in self.engines], np.int8)

    def hybrid_view_labels(self, entity_id: int) -> np.ndarray:
        """±1 membership per view via the §3.5.2 hybrid read tier (exact
        under every policy; no catch-up, at most one feature-table touch)."""
        if self.vectorized:
            return self.engine.hybrid_labels_of(entity_id)[0]
        return np.array([e.hybrid_label(entity_id)[0]
                         if isinstance(e, HazyEngine) else e.label(entity_id)
                         for e in self.engines], np.int8)

    def predict_via_views(self, entity_id: int) -> int:
        """Multiclass argmax resolved from the per-view hybrid reads, never
        a full-table scan. Exactly one positive one-vs-all view — the common
        case on a trained model — decides the class with NO feature read
        (its margin is the only non-negative one, hence the argmax); ties
        (>1) rank only the positive views' margins, and the no-positive case
        falls back to all k margins from one feature row. Agrees with
        `predict` on every input."""
        labels = self.hybrid_view_labels(entity_id)
        pos = np.flatnonzero(labels == 1)
        if pos.size == 1:
            return int(pos[0])
        f = self.F[entity_id]
        if self.vectorized:
            W, b = self.W, self.b
        else:
            W = np.stack([m.w for m in self._models])
            b = np.array([m.b for m in self._models], np.float64)
        cand = pos if pos.size > 1 else np.arange(self.k)
        scores = W[cand] @ f - b[cand].astype(np.float32)
        return int(cand[np.argmax(scores)])

    def check_consistent(self) -> bool:
        if self.vectorized:
            return self.engine.check_consistent()
        for e in self.engines:
            if isinstance(e, HazyEngine):
                if not e.check_consistent():
                    return False
            else:
                e.all_members()   # lazy naive: force the on-read relabel
                _, truth, _ = eps_affine(e.F, e._w, e._b)
                if not torch.equal(truth, e.labels):
                    return False
        return True
