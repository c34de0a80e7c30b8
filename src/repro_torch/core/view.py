"""`ClassificationView` — the `CREATE CLASSIFICATION VIEW` abstraction,
counterpart of `repro.core.view`.

Ties together: a corpus of entities (raw features or an encoder feature
function = any assigned backbone), an incrementally-trained linear model,
and a `HazyEngine` per §3. Reads are always exact w.r.t. the current model
— policy only moves *when* maintenance work happens (eager/lazy/hybrid).

The view owns training (SGD on the example stream, on its host f32 copy
of the features) and the read API; the engine shell holds the device copy
and owns storage layout and cost accounting; every algorithm rule the
shell executes lives once in `core/engine.py`. `device=None` means the
GPU.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hazy import HazyEngine, NaiveEngine
from repro_torch.core.linear_model import sgd_step, zero_model
from repro_torch.storage import BufferPool, EntityStore


class ClassificationView:
    def __init__(self, entities: np.ndarray, *,
                 feature_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 method: str = "svm", policy: str = "eager",
                 norm: Tuple[float, float] = (float("inf"), 1.0),
                 lr: float = 0.1, l2: float = 1e-4, alpha: float = 1.0,
                 buffer_frac: float = 0.01, engine: str = "hazy",
                 cost_mode: str = "measured", touch_ns: float = 0.0,
                 store=None, device=None):
        self.feature_fn = feature_fn
        F = feature_fn(entities) if feature_fn is not None else entities
        self.F = np.asarray(F, np.float32)
        self._entities = entities
        self.method = method
        self.lr, self.l2 = lr, l2
        self.model = zero_model(self.F.shape[1])
        p, q = norm
        self.hybrid = policy == "hybrid"
        # ctor parameters are stored ONCE and reused verbatim whenever the
        # engine is rebuilt (refresh_features) — nothing silently reverts.
        self._engine_kind = engine
        if engine == "hazy":
            # hybrid is a first-class HazyEngine policy (lazy maintenance +
            # §3.5.2 read tier) — no silent rewrite to eager.
            self._engine_kwargs = dict(
                p=p, q=q, alpha=alpha, policy=policy, cost_mode=cost_mode,
                touch_ns=touch_ns,
                buffer_frac=buffer_frac if self.hybrid else 0.0,
                store=store)
        else:
            if store is not None:
                raise ValueError("the storage tier (store=) requires "
                                 "engine='hazy'")
            self._engine_kwargs = dict(
                policy="lazy" if self.hybrid else policy, touch_ns=touch_ns)
        self._engine_kwargs["device"] = device
        self.engine = self._make_engine()
        self.examples: list = []

    def _make_engine(self):
        if self._engine_kind == "hazy":
            return HazyEngine(self.F, **self._engine_kwargs)
        return NaiveEngine(self.F, **self._engine_kwargs)

    # ------------------------------------------------------------------
    # Updates ("INSERT INTO Example_Papers ...")
    # ------------------------------------------------------------------

    def insert_example(self, entity_id: Optional[int], label: float,
                       feature: Optional[np.ndarray] = None):
        f = self.F[entity_id] if feature is None else np.asarray(feature, np.float32)
        self.examples.append((f, float(label)))
        self.model = sgd_step(self.model, f, float(label), lr=self.lr,
                              l2=self.l2, method=self.method)
        self.engine.apply_model(self.model)

    def insert_examples(self, ids: Sequence[int], labels: Sequence[float], *,
                        batched: bool = True,
                        features: Optional[np.ndarray] = None):
        """Insert a batch of training examples.

        `batched=True` is the fast path: SGD still runs example-by-example
        (identical model trajectory to k `insert_example` calls), but view
        maintenance is amortized to ONE `apply_model` round at the end —
        reads after the batch observe only the batch-final model, and the
        view stays exact w.r.t. it. `batched=False` reproduces the seed's
        per-example maintenance (one HAZY round per insert).

        `features` (a `(len(ids), d)` matrix) overrides the row lookup in
        `self.F` — the freshness scheduler uses this to train derived
        views on inputs pinned at emission time."""
        if not batched:
            for j, (i, y) in enumerate(zip(ids, labels)):
                self.insert_example(
                    i, y, None if features is None else features[j])
            return
        for j, (i, y) in enumerate(zip(ids, labels)):
            f = self.F[i] if features is None else np.asarray(features[j],
                                                             np.float32)
            self.examples.append((f, float(y)))
            self.model = sgd_step(self.model, f, float(y), lr=self.lr,
                                  l2=self.l2, method=self.method)
        self.engine.apply_model(self.model)

    def retrain_from_scratch(self):
        """Paper footnote 2: deletions/label-changes retrain non-incrementally."""
        self.model = zero_model(self.F.shape[1])
        for f, y in self.examples:
            self.model = sgd_step(self.model, f, y, lr=self.lr, l2=self.l2,
                                  method=self.method)
        self.engine.apply_model(self.model)
        if isinstance(self.engine, HazyEngine):
            self.engine.reorganize()

    def refresh_features(self, entities: Optional[np.ndarray] = None):
        """Feature function (backbone) changed: recompute F and recluster."""
        if entities is not None:
            self._entities = entities
        F = self.feature_fn(self._entities) if self.feature_fn else self._entities
        self.F = np.asarray(F, np.float32)
        old_pool = self._engine_kwargs.get("store")
        if old_pool is not None:
            # the storage tier mirrors F on disk: a new store over the new
            # rows at the SAME budget and page geometry. Only the old POOL
            # is closed: its EntityStore may be shared with sibling views
            # of the same table, and closing it is its owner's job (a
            # temp-file store removes its file when collected).
            self._engine_kwargs["store"] = BufferPool(
                EntityStore.from_array(self.F,
                                       page_bytes=old_pool.store.page_bytes),
                old_pool.budget_bytes)
            old_pool.close()
        self.engine = self._make_engine()   # same ctor kwargs: q, touch_ns,
        self.engine.apply_model(self.model)  # alpha … all survive the rebuild

    # ------------------------------------------------------------------
    # Reads
    # ------------------------------------------------------------------

    def label(self, entity_id: int) -> int:
        if self.hybrid and isinstance(self.engine, HazyEngine):
            lab, _ = self.engine.hybrid_label(entity_id)
            return lab
        return self.engine.label(entity_id)

    def all_members(self) -> int:
        return self.engine.all_members()

    def members(self) -> np.ndarray:
        return self.engine.members()
