"""The comparison that decides `correct`. The reference replays the
committed insert stream from zero models with its own copy of the SGD
step, and at each commit boundary judges the answers the judged side
gave under the models of that moment: every point read, the sampled
All-Members reads, and at the end every view's label of every row and
the models themselves. Numbers compared, each with its limit from the
configuration file:

  label_mismatches  labels that differ from the sign of the reference's
                    float64 margin and are no tie (`reference.labels`):
                    the final labels, the point reads' and the members
                    answers' together;
  model_gap         the largest gap between the judged side's models and
                    the reference's, over each view's largest weight
                    (the bias over the largest bias).

Several judged sides (the program and its control) share one replay."""
from __future__ import annotations

import numpy as np
import torch

from hazy_bench.reference import labels as L
from hazy_bench.reference.sgd import replay

NUMBERS = ("label_mismatches", "model_gap")


def _gap(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    scale = np.maximum(np.abs(want).max(axis=-1), np.finfo(np.float32).tiny)
    return float(np.max(np.abs(got - want).max(axis=-1) / scale))


def judge(F: np.ndarray, table: L.Table, commits, cfg: dict,
          sides: list) -> list:
    """For each side (a dict of `W`, `b`, `final`, `points`, `members`),
    {"label_mismatches", "model_gap", "parts"}."""
    k, n = cfg["views"], F.shape[0]
    dev = table.F.device
    st = []
    for s in sides:
        by_c = {}
        for c, view, ids in s["members"]:
            by_c.setdefault(c, []).append((view, ids))
        st.append({"ptr": 0, "by_c": by_c, "points": 0, "members": 0,
                   "final": 0, "wrong": 0})

    def visit(c, W, b):
        for s, t in zip(sides, st):
            pts = s["points"]
            j0 = t["ptr"]
            j1 = j0 + int(np.searchsorted(pts["c"][j0:], c, side="right"))
            if j1 > j0:
                z, tol = L.point_margins(F, pts["id"][j0:j1], W, b)
                want = np.where(z >= 0, 1, -1)
                bad = (pts["labels"][j0:j1] != want) & (np.abs(z) > tol)
                t["points"] += int(bad.sum())
                t["wrong"] += int(bad.any(axis=1).sum())
                t["ptr"] = j1
            for view, ids in t["by_c"].get(c, ()):
                v = slice(view, view + 1)
                z = table.margins(W[v], b[v])[0]
                tol = table.tolerance(W[v], b[v])[0]
                got = torch.zeros(n, dtype=torch.bool, device=dev)
                got[torch.from_numpy(np.asarray(ids, np.int64)).to(dev)] = True
                bad = int(((got != (z >= 0)) & (z.abs() > tol)).sum())
                t["members"] += bad
                t["wrong"] += bad > 0

    W, b = replay(F, commits, k, lr=cfg["lr"], l2=cfg["l2"], visit=visit)
    z = table.margins(W, b)
    tol = table.tolerance(W, b)
    want = L.sign(z)
    out = []
    for s, t in zip(sides, st):
        got = torch.as_tensor(s["final"], device=dev)
        if got.shape == want.shape:
            t["final"] = int(((got != want) & (z.abs() > tol)).sum())
        else:
            t["final"] = k * n
        parts = {"final": t["final"], "points": t["points"],
                 "members": t["members"],
                 "points_checked": int(s["points"]["c"].size),
                 "members_checked": len(s["members"]),
                 "final_checked": k * n, "answers_wrong": t["wrong"]}
        out.append({
            "label_mismatches": t["final"] + t["points"] + t["members"],
            "model_gap": max(_gap(s["W"], W), _gap(s["b"][None], b[None])),
            "parts": parts})
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number within its limit; a NaN is outside any limit."""
    return all(float(numbers[m]) <= float(limits[m]) for m in NUMBERS)
