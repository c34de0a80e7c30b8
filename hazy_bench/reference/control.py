"""The control: the reference put in the program's place one precision
below what the configuration states (W in bfloat16 and b in float32
through the SGD; every label from TF32 products), answering the very
operations a run of the program answered. The judge has to find it
not correct."""
from __future__ import annotations

import numpy as np

from hazy_bench.reference import labels as L
from hazy_bench.reference.sgd import replay


def answers(F: np.ndarray, table: L.Table, run: dict, cfg: dict) -> dict:
    """The control's outputs in the form `client.Client.outputs` gives
    the program's: models, final labels, point and members answers."""
    pc, pid = run["points"]["c"], run["points"]["id"]
    plab = np.empty((pc.size, cfg["views"]), np.int8)
    members = []
    want = {}
    for j, (c, view, _) in enumerate(run["members"]):
        want.setdefault(c, []).append((j, view))
    nxt = [0]

    def visit(c, W, b):
        j0 = nxt[0]
        j1 = j0 + int(np.searchsorted(pc[j0:], c, side="right"))
        if j1 > j0:
            f = L.tf32_np(F[pid[j0:j1]])
            z = f @ L.tf32_np(W).T - np.asarray(b, np.float32)
            plab[j0:j1] = np.where(z >= 0, 1, -1)
            nxt[0] = j1
        for j, view in want.get(c, ()):
            z = table.margins_tf32(W[view:view + 1], b[view:view + 1])[0]
            members.append((c, view, np.flatnonzero(
                (z >= 0).cpu().numpy()).astype(np.int32)))

    W, b = replay(F, run["commits"], cfg["views"], lr=cfg["lr"],
                  l2=cfg["l2"], visit=visit, lower=True)
    final = L.sign(table.margins_tf32(W, b)).cpu().numpy()
    return {"W": W, "b": b, "final": final,
            "points": {"c": pc, "id": pid, "labels": plab},
            "members": members}
