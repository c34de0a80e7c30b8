"""Hölder waters (paper §3.2.2, Lemma 3.1, Eq. 2), counterpart of
`repro.core.waters`: `holder_M` for data preparation, `vector_norm`,
`eps_bounds` and the scalar `Waters` shell the single-view engines carry.
The update itself is `engine.waters_update`, so the port's waters are
bit-identical to the reference's."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.engine import row_norms, waters_bounds, waters_update
from repro_torch.core.linear_model import LinearModel


def vector_norm(x: np.ndarray, p: float) -> float:
    """Scalar p-norm of one vector."""
    return float(row_norms(np.asarray(x), p))


def holder_M(F: np.ndarray, q: float) -> float:
    """M = max row q-norm of the entity features (host numpy)."""
    return float(np.max(row_norms(np.asarray(F), q)))


def eps_bounds(current: LinearModel, stored: LinearModel, M: float,
               p: float) -> Tuple[float, float]:
    """(eps_low, eps_high) of Lemma 3.1 for this round."""
    lo, hi = waters_bounds(current.w, current.b, stored.w, stored.b, M, p)
    return float(lo), float(hi)


@dataclasses.dataclass
class Waters:
    """Running (lw, hw) per Eq. 2, monotone between reorganizations."""
    p: float
    M: float
    lw: float = 0.0
    hw: float = 0.0

    def reset(self):
        self.lw = 0.0
        self.hw = 0.0

    def update(self, current: LinearModel, stored: LinearModel) -> Tuple[float, float]:
        lw, hw = waters_update(self.lw, self.hw, current.w, current.b,
                               stored.w, stored.b, self.M, self.p)
        self.lw, self.hw = float(lw), float(hw)
        return self.lw, self.hw
