"""Layer 1 of the HAZY maintenance core (§3.2–3.5), in PyTorch.

Counterpart of `repro.core.engine` Layer 1: every algorithm rule of the
port lives here exactly once, and the rest of `repro_torch` imports it.

Two kinds of primitive, split by where the JAX driver runs them:

  * host control math, numpy float64, written exactly as the reference
    evaluates it with `xp=np` — `row_norms`, `waters_bounds`,
    `waters_update`, `skiing_charge`, `skiing_due`, and `f32_ceil`. The
    port's waters are therefore bit-identical to the reference's by
    construction;
  * device forms over torch tensors — `classify`, `band_partition`,
    `band_windows`, `band_bounds` (at host waters), `band_mask`,
    `probe_partition`, `hot_buffer_window`, `covering_windows`,
    `argsort_stable`. Comparisons run in the dtype of the eps tensor (the
    sharded drivers hand the waters to the device as f32, as the
    reference does; the host shells search at `f32_ceil` of their
    float64 waters, which finds what numpy's float64 search finds).

The Lemma 3.1 partition: eps ≥ hw is certainly positive (z ≥ 0 labels
+1), eps < lw certainly negative, eps ∈ [lw, hw) must be reclassified.

Layer 2 (`EngineState` and its pure steps) is not ported yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# hybrid tier codes returned by the §3.5.2 probes (index into HYBRID_TIERS):
# waters short-circuit, hot buffer, and "the feature row was touched"
# (disk). A shell that backs the touch with a storage tier subdivides it
# into a pool hit (TIER_POOL, PROBE_TIERS[3]) and a cold disk read.
HYBRID_TIERS = ("water", "buffer", "disk")
TIER_WATER, TIER_BUFFER, TIER_DISK = 0, 1, 2
TIER_POOL = 3
PROBE_TIERS = HYBRID_TIERS + ("pool",)


# ---------------------------------------------------------------------------
# host control math (numpy, float64 where the reference keeps float64)
# ---------------------------------------------------------------------------

def row_norms(X: np.ndarray, p: float) -> np.ndarray:
    """p-norm over the LAST axis: (..., d) -> (...,), dtype-preserving.
    The one norm behind the Hölder waters (Eq. 2)."""
    if X.shape[-1] == 0:
        return np.zeros(X.shape[:-1], X.dtype)
    A = np.abs(X)
    if math.isinf(p):
        return np.max(A, axis=-1)
    if p == 1.0:
        return np.sum(A, axis=-1)
    return np.sum(A ** p, axis=-1) ** (1.0 / p)


def waters_bounds(W, b, W_stored, b_stored, M: float, p: float):
    """One round of Lemma 3.1 bounds: (−M‖ΔW‖_p + Δb, M‖ΔW‖_p + Δb).
    W may be a single (d,) model or stacked (k, d) models."""
    dw = row_norms(W - W_stored, p)
    db = b - b_stored
    return -M * dw + db, M * dw + db


def waters_update(lw, hw, W, b, W_stored, b_stored, M: float, p: float):
    """Eq. 2 running waters: lw never rises, hw never falls between
    reorganizations. THE waters update."""
    lo, hi = waters_bounds(W, b, W_stored, b_stored, M, p)
    return np.minimum(lw, lo), np.maximum(hw, hi)


def skiing_charge(acc, cost):
    """THE SKIING charge rule: accumulate one incremental-step cost."""
    return acc + cost


def skiing_due(acc, alpha, S):
    """SKIING trigger (Fig. 7): reorganize when the accumulated
    incremental cost has reached α·S."""
    return acc >= alpha * S


def f32_ceil(x) -> np.ndarray:
    """The least float32 ≥ x, elementwise, for float64 waters x. For every
    float32 e, e < x ⇔ e < f32_ceil(x), so a float32 search at f32_ceil(x)
    finds the position that numpy's search of a float32 eps row at the
    float64 x finds (numpy compares the two in float64)."""
    x = np.asarray(x, np.float64)
    c = x.astype(np.float32)
    return np.where(c.astype(np.float64) < x,
                    np.nextafter(c, np.float32(np.inf)), c)


# ---------------------------------------------------------------------------
# device forms (torch tensors)
# ---------------------------------------------------------------------------

def classify(z: torch.Tensor) -> torch.Tensor:
    """Sign labels: z ≥ 0 → +1 else −1, int8."""
    return torch.where(z >= 0, 1, -1).to(torch.int8)


def band_partition(eps_sorted: torch.Tensor, lw, hw):
    """THE Lemma 3.1 partition: [lo, hi) such that positions ≥ hi are
    certainly positive (eps ≥ hw), positions < lo certainly negative
    (eps < lw), and [lo, hi) is the band. One (n,) eps-sorted row with
    scalar waters, or (k, n) rows with (k,) waters, in one search; lw and
    hw are numbers, arrays or tensors. lo and hi are int64 tensors of the
    waters' shape on eps's device (no host sync)."""
    dev, dt = eps_sorted.device, eps_sorted.dtype
    bounds = torch.stack([torch.as_tensor(x, dtype=dt, device=dev)
                          for x in (lw, hw)], dim=-1)
    out = torch.searchsorted(eps_sorted, bounds, side="left")
    return out[..., 0], out[..., 1]


# the reference's name for the k-row form
band_windows = band_partition


def band_bounds(eps_sorted: torch.Tensor, lw, hw):
    """`band_partition` of float32 eps-sorted rows at float64 host waters,
    as the numpy reference takes it: searched at `f32_ceil` of the waters,
    so [lo, hi) is numpy's float64 search. Returns host int64 arrays (one
    round trip)."""
    bounds = torch.tensor(f32_ceil(np.stack([lw, hw], axis=-1)),
                          device=eps_sorted.device)
    out = torch.searchsorted(eps_sorted, bounds, side="left")
    return np.moveaxis(out.cpu().numpy(), -1, 0)


def band_mask(eps, lw, hw):
    """Elementwise Lemma 3.1 band membership: eps ∈ [lw, hw), for eps rows
    in any order."""
    return (eps >= lw) & (eps < hw)


def probe_partition(eps: torch.Tensor, lw, hw) -> torch.Tensor:
    """Point-probe form of the partition: +1 (eps ≥ hw), −1 (eps < lw),
    0 (in the band: classify against the current model)."""
    return torch.where(eps >= hw, 1, torch.where(eps < lw, -1, 0)).to(
        torch.int8)


def hot_buffer_window(eps_sorted: torch.Tensor, cap: int):
    """[lo, hi) positions of the §3.5.2 hot buffer: `cap` eps-sorted slots
    centred on the zero boundary (the rows most likely to flip). eps_sorted
    is one (n,) row or (k, n) rows; lo and hi are int64 tensors of its
    leading shape on its device (no host sync)."""
    n = eps_sorted.shape[-1]
    cap = max(1, min(int(cap), n))
    zero = torch.zeros(eps_sorted.shape[:-1] + (1,), dtype=eps_sorted.dtype,
                       device=eps_sorted.device)
    boundary = torch.searchsorted(eps_sorted, zero, side="left")[..., 0]
    lo = torch.clamp(boundary - cap // 2, min=0)
    return lo, torch.clamp(lo + cap, max=n)


def covering_windows(eps: torch.Tensor, lw: torch.Tensor, hw: torch.Tensor):
    """Per-view covering windows of the Lemma 3.1 band in a SHARED row
    order. eps: (k, n); lw, hw: (k,). Returns int32 ((k,) start, (k,) end,
    (k,) true band width); [start_v, end_v) is the tightest contiguous
    window holding every band row of view v, and an empty band gets the
    empty window [0, 0). Stays on eps's device: no host sync."""
    k, n = eps.shape
    mask = band_mask(eps, lw[:, None], hw[:, None])
    width = mask.sum(dim=1, dtype=torch.int32)
    m8 = mask.to(torch.uint8)        # argmax takes no bool; first max wins
    first = torch.argmax(m8, dim=1).to(torch.int32)
    last = (n - 1 - torch.argmax(torch.flip(m8, dims=(1,)), dim=1)).to(
        torch.int32)
    has = width > 0
    zero = torch.zeros_like(first)
    start = torch.where(has, first, zero)
    end = torch.where(has, last + 1, zero)
    return start, end, width


def argsort_stable(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Stable argsort: ties keep row order, so identical eps give identical
    clustering permutations on every device."""
    return torch.argsort(x, dim=dim, stable=True)
