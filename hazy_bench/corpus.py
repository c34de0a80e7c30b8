"""The tables a configuration names, drawn from the seed on the device in
a few large calls (a `torch.Generator` on that device), then copied to
the host once: the program takes its table as a host array. Copies of the
patterns of `repro_torch.data.corpora`, kept here so that later changes
to the program cannot move the data. Every step is deterministic on its
device: writes go through index tensors that name each element once."""
from __future__ import annotations

import numpy as np
import torch


def _normalize(x: torch.Tensor, norm: str) -> torch.Tensor:
    if norm == "l1":
        s = x.abs().sum(dim=1, keepdim=True)
    else:
        s = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x.div_(s.clamp_min_(1e-12))


def bag_of_words(cfg: dict, g: torch.Generator, dev) -> tuple:
    """Hashed bag-of-words rows: `words_per_row` words at uniform hashed
    columns with exponential weights (colliding words add, as the hashing
    trick does), plus the row's class's own `topic_columns_per_view`
    columns with exponential weights of mean `topic_weight_mean` (the
    pattern `synthetic_corpus` uses for two classes), rows normalised."""
    n, d, k = cfg["rows"], cfg["width"], cfg["views"]
    nnz, nt = cfg["words_per_row"], cfg["topic_columns_per_view"]
    if k * nt > d:
        raise ValueError(f"{k} views x {nt} topic columns exceed {d}")
    cls = _classes(cfg, g, dev)
    cols = torch.randint(0, d, (n, nnz), generator=g, device=dev)
    vals = torch.empty((n, nnz), device=dev).exponential_(
        1.0 / cfg["word_weight_mean"], generator=g)
    topic = torch.empty((n, nt), device=dev).exponential_(
        1.0 / cfg["topic_weight_mean"], generator=g)
    x = torch.zeros((n, d), device=dev)
    rows = torch.arange(n, device=dev)
    for j in range(nnz):               # one word a row a call: no collisions
        x[rows, cols[:, j]] += vals[:, j]
    x[rows[:, None], cls[:, None] * nt
      + torch.arange(nt, device=dev)[None, :]] += topic
    return _normalize(x, cfg["norm"]), cls


def _classes(cfg: dict, g: torch.Generator, dev) -> torch.Tensor:
    """A class a row: in the shares of `class_counts` where the file gives
    them (a published data set's class sizes), else uniform."""
    n, k = cfg["rows"], cfg["views"]
    counts = cfg.get("class_counts")
    if counts is None:
        return torch.randint(0, k, (n,), generator=g, device=dev)
    if len(counts) != k:
        raise ValueError(f"{len(counts)} class counts for {k} views")
    p = torch.tensor(counts, dtype=torch.float64, device=dev)
    return torch.multinomial(p / p.sum(), n, replacement=True, generator=g)


def gaussian_clusters(cfg: dict, g: torch.Generator, dev) -> tuple:
    """One cluster a class (`multiclass_corpus`): centres N(0, sep²) a
    feature, rows centre + N(0, 1), normalised."""
    n, d, k = cfg["rows"], cfg["width"], cfg["views"]
    centres = torch.randn((k, d), generator=g, device=dev) * cfg["separation"]
    cls = _classes(cfg, g, dev)
    x = centres[cls] + torch.randn((n, d), generator=g, device=dev)
    return _normalize(x, cfg["norm"]), cls


KINDS = {"bag_of_words": bag_of_words, "gaussian_clusters": gaussian_clusters}


def make(cfg: dict, seed: int, device) -> tuple:
    """(features (n, d) float32, classes (n,) int64), host arrays."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    x, cls = KINDS[cfg["corpus"]](cfg, g, dev)
    out = x.cpu().numpy(), cls.cpu().numpy().astype(np.int64)
    del x, cls
    return out
