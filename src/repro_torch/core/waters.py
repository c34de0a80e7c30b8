"""Hölder waters helpers (paper §3.2.2, Lemma 3.1, Eq. 2), counterpart of
`repro.core.waters`: `holder_M` for data preparation and `vector_norm`.
The update itself is `engine.waters_update`. `Waters` and `eps_bounds`
need the single-view `LinearModel` and are not ported yet."""
from __future__ import annotations

import numpy as np

from repro_torch.core.engine import row_norms


def vector_norm(x: np.ndarray, p: float) -> float:
    """Scalar p-norm of one vector."""
    return float(row_norms(np.asarray(x), p))


def holder_M(F: np.ndarray, q: float) -> float:
    """M = max row q-norm of the entity features (host numpy)."""
    return float(np.max(row_norms(np.asarray(F), q)))
