"""One generator for every traffic mix. A mix file gives the operation
shares (`insert`, `point_read`, `members`), the rows of a group commit,
and optionally an All-Members read after every m-th commit. Operations
are drawn from the seed in fixed blocks, so a seed gives one sequence
whatever share of it a run consumes. Ids are uniform over the table.

Operations:
  ("commit", ids, classes)  a group commit of training inserts;
  ("point", id)             every view's label of one entity;
  ("members", view)         the ids a view labels positive (views in turn).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

BLOCK = 4096
KINDS = ("insert", "point_read", "members")


def stream(mix: dict, classes: np.ndarray, views: int, label_noise: float,
           seed: int) -> Iterator[tuple]:
    rng = np.random.default_rng(int(seed))
    n = classes.shape[0]
    probs = np.array([mix["mix"].get(kd, 0.0) for kd in KINDS])
    if not np.isclose(probs.sum(), 1.0):
        raise ValueError(f"mix {mix['name']}: shares sum to {probs.sum()}")
    rows, every = mix["commit_rows"], mix.get("members_every_commits", 0)
    ids, cls = [], []
    commits = view = 0
    while True:
        kind = rng.choice(len(KINDS), size=BLOCK, p=probs)
        ent = rng.integers(0, n, BLOCK)
        noisy = rng.random(BLOCK) < label_noise
        other = rng.integers(1, max(views, 2), BLOCK)
        for j in range(BLOCK):
            if kind[j] == 0:
                c = int(classes[ent[j]])
                ids.append(int(ent[j]))
                cls.append((c + int(other[j])) % views if noisy[j] else c)
                if len(ids) == rows:
                    yield ("commit", ids, cls)
                    ids, cls = [], []
                    commits += 1
                    if every and commits % every == 0:
                        yield ("members", view)
                        view = (view + 1) % views
            elif kind[j] == 1:
                yield ("point", int(ent[j]))
            else:
                yield ("members", view)
                view = (view + 1) % views
