"""Synthetic clones of the paper's data sets (Figure 3 statistics), a
numpy copy of `repro.data.corpora`: equal seeds give equal arrays.

  Forest  (FC): 582k entities, 54 dense features        [UCI covtype]
  DBLife  (DB): 124k entities, 41k vocab, ~7 nnz/doc    [bag-of-words, title]
  Citeseer(CS): 721k entities, 682k vocab, ~60 nnz/doc  [bag-of-words, abstract]

Sparse corpora go through the hashing trick into a dense `hash_dim`; the
Hölder machinery only needs M = max ||f||_q computed on the hashed
vectors. Labels come from a hidden ground-truth halfspace plus flip
noise, and a training-example stream is available for update workloads.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class Corpus:
    name: str
    features: np.ndarray      # (n, d) float32, row-normalized
    labels: np.ndarray        # (n,) ±1 ground truth
    true_w: np.ndarray        # hidden model (for quality eval)
    true_b: float
    norm: str                 # "l1" | "l2" — which normalization rows carry


def _normalize(x: np.ndarray, norm: str) -> np.ndarray:
    if norm == "l1":
        s = np.sum(np.abs(x), axis=1, keepdims=True)
    else:
        s = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(s, 1e-12)


def synthetic_corpus(name: str, n: int, d: int, *, nnz: int = 0, norm: str = "l2",
                     noise: float = 0.02, seed: int = 0,
                     separation: float = 2.5) -> Corpus:
    """Two class-conditional clusters pushed `separation` apart along a
    hidden direction — real corpora (Forest, DBLife) have low margin density
    at the decision boundary after convergence, which is what makes the
    paper's steady-state band ~1% (Fig. 13); an unstructured gaussian cloud
    would not reproduce that."""
    r = np.random.default_rng(seed)
    y = np.where(r.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    if nnz and nnz < d:
        # sparse bag-of-words via hashing trick: nnz active hashed buckets,
        # plus class-specific "topic" columns (db-papers use db words)
        x = np.zeros((n, d), np.float32)
        cols = r.integers(0, d, size=(n, nnz))
        vals = r.exponential(1.0, size=(n, nnz)).astype(np.float32)
        np.put_along_axis(x, cols, vals, axis=1)
        n_topic = max(2, nnz // 3)
        pos_cols = np.arange(n_topic)
        neg_cols = np.arange(n_topic, 2 * n_topic)
        topic = r.exponential(separation, size=(n, n_topic)).astype(np.float32)
        pos = y > 0
        x[np.ix_(pos, pos_cols)] += topic[pos]
        x[np.ix_(~pos, neg_cols)] += topic[~pos]
        u = np.zeros(d, np.float32)
        u[pos_cols] = 1.0
        u[neg_cols] = -1.0
        u /= np.linalg.norm(u)
    else:
        u = r.normal(size=d).astype(np.float32)
        u /= np.linalg.norm(u)
        x = r.normal(size=(n, d)).astype(np.float32) + 0.1
        x += np.outer(y * separation, u)
    x = _normalize(x, norm).astype(np.float32)
    w = u
    b = 0.0
    flip = r.random(n) < noise
    y = y.copy()
    y[flip] *= -1
    return Corpus(name, x, y, w, b, norm)


def forest_like(scale: float = 1.0, seed: int = 0) -> Corpus:
    return synthetic_corpus("FC", max(1000, int(582_000 * scale)), 54,
                            norm="l2", seed=seed)


def dblife_like(scale: float = 1.0, hash_dim: int = 1024, seed: int = 1) -> Corpus:
    return synthetic_corpus("DB", max(1000, int(124_000 * scale)), hash_dim,
                            nnz=7, norm="l1", seed=seed)


def citeseer_like(scale: float = 1.0, hash_dim: int = 4096, seed: int = 2) -> Corpus:
    return synthetic_corpus("CS", max(1000, int(721_000 * scale)), hash_dim,
                            nnz=60, norm="l1", seed=seed)


@dataclasses.dataclass
class MulticlassCorpus:
    name: str
    features: np.ndarray      # (n, d) float32, row-normalized
    classes: np.ndarray       # (n,) int class ids
    num_classes: int


def multiclass_corpus(name: str, n: int, d: int, num_classes: int, *,
                      separation: float = 2.5, norm: str = "l2",
                      seed: int = 0) -> MulticlassCorpus:
    """k class-conditional clusters — the one-vs-all workload of the
    paper's multiclass experiments (App. B.5.4 / C.3)."""
    r = np.random.default_rng(seed)
    centers = (r.normal(size=(num_classes, d)) * separation).astype(np.float32)
    cls = r.integers(0, num_classes, n)
    x = centers[cls] + r.normal(size=(n, d)).astype(np.float32)
    x = _normalize(x, norm).astype(np.float32)
    return MulticlassCorpus(name, x, cls.astype(np.int64), num_classes)


def cora_like(scale: float = 1.0, num_classes: int = 7, hash_dim: int = 64,
              seed: int = 5) -> MulticlassCorpus:
    """Cora: 2708 papers, 7 topics. The binary word vectors go through the
    hashing trick into `hash_dim` dense dims (same adaptation as DB/CS)."""
    return multiclass_corpus("CORA", max(256, int(2708 * scale)), hash_dim,
                             num_classes, seed=seed)


def multiclass_example_stream(corpus: MulticlassCorpus, *, seed: int = 0
                              ) -> Iterator[Tuple[int, int]]:
    """Infinite stream of (entity_id, class) training inserts."""
    r = np.random.default_rng(seed)
    n = corpus.features.shape[0]
    while True:
        i = int(r.integers(0, n))
        yield i, int(corpus.classes[i])


def example_stream(corpus: Corpus, *, seed: int = 0,
                   label_noise: float = 0.02) -> Iterator[Tuple[int, np.ndarray, float]]:
    """Infinite stream of (id, feature, label) training examples — the
    paper's `INSERT INTO Example_Papers` workload."""
    r = np.random.default_rng(seed)
    n = corpus.features.shape[0]
    while True:
        i = int(r.integers(0, n))
        y = corpus.labels[i]
        if r.random() < label_noise:
            y = -y
        yield i, corpus.features[i], float(y)
