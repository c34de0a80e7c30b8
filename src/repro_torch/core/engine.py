"""The HAZY maintenance core (§3.2–3.5), in PyTorch: the counterpart of
`repro.core.engine`. Every algorithm rule of the port lives here exactly
once, and the rest of `repro_torch` imports it.

Layer 1 — primitives.

Two kinds of primitive, split by where the JAX driver runs them:

  * host control math, numpy float64, written exactly as the reference
    evaluates it with `xp=np` — `row_norms`, `waters_bounds`,
    `waters_update`, `skiing_charge`, `skiing_due`, `f32_ceil`, and
    `host_classify` for a row the storage tier read on the host. The
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

Layer 2 — `EngineState` and its pure steps (`make_params`, `init_state`,
`reorganize`, `apply_model` under eager, lazy and hybrid, `catch_up`,
`hybrid_probe`): the executable specification of one maintenance round
over k views sharing ONE feature table, which the shells are held to.
Each step returns a new state and mutates none. The state is split as the
shells split theirs: the (k,)-sized control fields are numpy on the host,
computed by the host rules above (so the waters equal the numpy core's
bit for bit), and the bulk fields are tensors on the state's device. A
step computes the reference's full (k, n) product `(F @ W.T − b32).T`
with `torch.matmul`, searches the bands with `band_bounds` (one search a
step) and copies the (k,) results it needs to the host once. Modeled
costs are dimensionless, as in the reference: S cancels, so the SKIING
threshold is α.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import full_fp32, resolve_device

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


def host_classify(z) -> np.ndarray:
    """Sign labels of host margins: z ≥ 0 → +1 else −1, int8 — `classify`
    for the rows a shell reads through its storage tier and classifies on
    the host, as the reference does."""
    return np.where(np.asarray(z) >= 0, 1, -1).astype(np.int8)


def host_probe_partition(eps, lw, hw) -> np.ndarray:
    """`probe_partition` of float32 eps read back to the host: +1 (eps ≥
    hw), −1 (eps < lw), 0 (in the band), int8. The waters are taken in
    float32, as the device form takes them, so the two agree bit for
    bit."""
    eps = np.asarray(eps, np.float32)
    lw, hw = np.asarray(lw, np.float32), np.asarray(hw, np.float32)
    return np.where(eps >= hw, 1, np.where(eps < lw, -1, 0)).astype(np.int8)


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


# ---------------------------------------------------------------------------
# Layer 2 — EngineState + pure steps (the executable specification)
# ---------------------------------------------------------------------------

class EngineParams(NamedTuple):
    """Static hyper-parameters of the maintenance algorithm."""
    M: float                 # Hölder constant max_t ‖f(t)‖_q
    p: float                 # waters norm (1/p + 1/q = 1)
    alpha: float             # SKIING threshold multiplier
    buffer_cap: int = 0      # §3.5.2 hot-buffer rows per view (0 = off)


class EngineState(NamedTuple):
    """k one-vs-all views over ONE shared feature table. F stays in entity
    order; reorganization re-sorts the per-view scratch rows, never the
    table. Host fields are numpy, bulk fields tensors on F's device."""
    F: torch.Tensor          # (n, d) f32 on the device, entity order
    W: np.ndarray            # (k, d) f32 current models (host)
    b: np.ndarray            # (k,) float64 current biases
    W_stored: np.ndarray     # (k, d) f32 models the clustering was built on
    b_stored: np.ndarray     # (k,) float64
    lw: np.ndarray           # (k,) float64 low waters
    hw: np.ndarray           # (k,) float64 high waters
    eps_sorted: torch.Tensor  # (k, n) f32 stored-model eps, sorted per view
    perm: torch.Tensor       # (k, n) int64 position -> entity id
    inv_perm: torch.Tensor   # (k, n) int64 entity id -> position
    labels: torch.Tensor     # (k, n) int8, aligned to eps_sorted
    pos_count: np.ndarray    # (k,) int64 number of +1 labels per view
    pending: np.ndarray      # (k,) bool — view defers maintenance
    acc: np.ndarray          # (k,) float64 SKIING accumulators
    buffer_lo: np.ndarray    # (k,) int64 hot-buffer window starts
    buffer_hi: np.ndarray    # (k,) int64 hot-buffer window ends


def make_params(F, *, p: float = 2.0, q: float = 2.0, alpha: float = 1.0,
                buffer_frac: float = 0.0) -> EngineParams:
    """The parameters for the host table F (n, d)."""
    F = np.asarray(F, np.float32)
    cap = max(1, int(buffer_frac * F.shape[0])) if buffer_frac else 0
    return EngineParams(M=float(np.max(row_norms(F, q))), p=p, alpha=alpha,
                        buffer_cap=cap)


def init_state(F, k: int, params: EngineParams, device=None) -> EngineState:
    """Fresh state under the zero model, all k views clustered, with the
    bulk fields on `device` (None means the GPU; without one only
    device="cpu" runs)."""
    dev = resolve_device(device)
    full_fp32()
    F = np.ascontiguousarray(F, np.float32)
    n, d = F.shape
    zk = np.zeros(k, np.float64)

    def rows(dtype):
        return torch.zeros((k, n), dtype=dtype, device=dev)

    state = EngineState(
        F=torch.tensor(F, device=dev), W=np.zeros((k, d), np.float32),
        b=zk.copy(), W_stored=np.zeros((k, d), np.float32),
        b_stored=zk.copy(), lw=zk.copy(), hw=zk.copy(),
        eps_sorted=rows(torch.float32), perm=rows(torch.int64),
        inv_perm=rows(torch.int64), labels=rows(torch.int8),
        pos_count=np.zeros(k, np.int64), pending=np.zeros(k, bool),
        acc=zk.copy(), buffer_lo=np.zeros(k, np.int64),
        buffer_hi=np.zeros(k, np.int64))
    return reorganize(state, np.ones(k, bool), params)


def _margins(state: EngineState) -> torch.Tensor:
    """(k, n) current-model margins in entity order: the reference's
    `(F @ W.T − b32).T`, b rounded to f32 as numpy rounds it."""
    dev = state.F.device
    W = torch.tensor(state.W, device=dev)
    b32 = torch.tensor(state.b.astype(np.float32), device=dev)
    return (state.F @ W.T - b32).T


def reorganize(state: EngineState, due,
               params: EngineParams) -> EngineState:
    """Re-sort the scratch rows of every view in `due` from one shared
    product; reset their stored models, waters, SKIING accumulators and
    pending flags. F itself never moves. No view due: the state as it
    is."""
    due = np.asarray(due, bool)
    if not due.any():
        return state
    Z = _margins(state)
    order = argsort_stable(Z, dim=1)
    eps_new = torch.gather(Z, 1, order)
    inv_new = argsort_stable(order, dim=1)            # inverse permutation
    labels_new = classify(eps_new)
    # the (k,) results the host keeps, in one copy
    host = [(labels_new == 1).sum(1)]
    if params.buffer_cap:
        host += hot_buffer_window(eps_new, params.buffer_cap)
    host = torch.stack(host).cpu().numpy()
    dr = torch.tensor(due, device=state.F.device)[:, None]
    out = state._replace(
        eps_sorted=torch.where(dr, eps_new, state.eps_sorted),
        perm=torch.where(dr, order, state.perm),
        inv_perm=torch.where(dr, inv_new, state.inv_perm),
        labels=torch.where(dr, labels_new, state.labels),
        pos_count=np.where(due, host[0], state.pos_count),
        W_stored=np.where(due[:, None], state.W, state.W_stored),
        b_stored=np.where(due, state.b, state.b_stored),
        lw=np.where(due, 0.0, state.lw), hw=np.where(due, 0.0, state.hw),
        pending=state.pending & ~due,
        acc=np.where(due, 0.0, state.acc))
    if params.buffer_cap:
        out = out._replace(buffer_lo=np.where(due, host[1], state.buffer_lo),
                           buffer_hi=np.where(due, host[2], state.buffer_hi))
    return out


def _relabel(state: EngineState, sel, params: EngineParams):
    """Waters update + banded reclassify of the views in `sel` (the shared
    incremental step). Returns (state', lo, widths), host arrays."""
    sel = np.asarray(sel, bool)
    n = state.eps_sorted.shape[1]
    lw, hw = waters_update(state.lw, state.hw, state.W, state.b,
                           state.W_stored, state.b_stored,
                           params.M, params.p)
    lw = np.where(sel, lw, state.lw)
    hw = np.where(sel, hw, state.hw)
    lo, hi = band_bounds(state.eps_sorted, lw, hw)
    dev = state.F.device
    lo_hi_sel = torch.tensor(np.stack([lo, hi, sel]), device=dev)[:, :, None]
    pos = torch.arange(n, device=dev)[None, :]
    in_band = (pos >= lo_hi_sel[0]) & (pos < lo_hi_sel[1]) & (
        lo_hi_sel[2] != 0)
    Zs = torch.gather(_margins(state), 1, state.perm)   # per-view eps order
    labels = torch.where(in_band, classify(Zs), state.labels)
    pos_count = (labels == 1).sum(1).cpu().numpy()
    widths = np.where(sel, hi - lo, 0)
    return (state._replace(lw=lw, hw=hw, labels=labels, pos_count=pos_count),
            lo, widths)


def apply_model(state: EngineState, W, b, params: EngineParams,
                policy: str = "eager"):
    """One maintenance round: the k views must reflect (W, b). Eager pays
    the banded reclassify now (SKIING check-first, Fig. 7); lazy defers
    everything to `catch_up`; hybrid defers the relabel but keeps the
    eps-map tight (SKIING charged with the expected probe miss rate).
    Returns (state', info) with info = {reorged (k,) bool, widths (k,)}."""
    k, n = state.eps_sorted.shape
    state = state._replace(W=np.array(W, np.float32),
                           b=np.array(b, np.float64))
    if policy == "eager":
        due = skiing_due(state.acc, params.alpha, 1.0)
        state = reorganize(state, due, params)
        state, _, widths = _relabel(state, ~due, params)
        state = state._replace(acc=skiing_charge(state.acc, widths / n))
        return state, {"reorged": due, "widths": widths}
    state = state._replace(pending=np.ones(k, bool))
    if policy == "hybrid":
        lw, hw = waters_update(state.lw, state.hw, state.W, state.b,
                               state.W_stored, state.b_stored,
                               params.M, params.p)
        state = state._replace(lw=lw, hw=hw)
        lo, hi = band_bounds(state.eps_sorted, lw, hw)
        state = state._replace(acc=skiing_charge(state.acc, (hi - lo) / n))
        due = skiing_due(state.acc, params.alpha, 1.0)
        state = reorganize(state, due, params)
        return state, {"reorged": due, "widths": hi - lo}
    return state, {"reorged": np.zeros(k, bool),
                   "widths": np.zeros(k, np.int32)}


def catch_up(state: EngineState, touch, params: EngineParams):
    """Catch up the pending subset of the touched views (per-view laziness:
    untouched views keep deferring). Charges the §3.4 lazy waste
    (N_R − N_+)/N_R per caught-up view and reorganizes the ones SKIING says
    are due. Returns (state', info)."""
    n = state.eps_sorted.shape[1]
    todo = state.pending & np.asarray(touch, bool)
    state, lo, widths = _relabel(state, todo, params)
    n_read = np.maximum(1, n - lo)
    waste = np.where(todo,
                     np.maximum(0.0, (n_read - state.pos_count) / n_read),
                     0.0)
    acc = skiing_charge(state.acc, waste)
    due = skiing_due(acc, params.alpha, 1.0) & todo
    state = reorganize(state._replace(pending=state.pending & ~todo, acc=acc),
                       due, params)
    return state, {"reorged": due, "caught_up": todo, "waste": waste,
                   "widths": widths}


def hybrid_probe(state: EngineState, entity_id: int, params: EngineParams):
    """§3.5.2/Fig. 8 single-entity read across all k views: eps-map lookup →
    waters short-circuit (`probe_partition`, float32 eps against the
    float64 waters in float64, as numpy compares them) → hot buffer → one
    shared F-row touch for every view the waters cannot resolve. Exact
    under every policy: a pending model only needs the monotone waters
    update. Returns (state', (k,) int8 labels, (k,) int8 tiers), host
    arrays (one copy from the device)."""
    lw, hw = waters_update(state.lw, state.hw, state.W, state.b,
                           state.W_stored, state.b_stored,
                           params.M, params.p)
    state = state._replace(lw=lw, hw=hw)
    eid = int(entity_id)
    dev = state.F.device
    posn = state.inv_perm[:, eid]
    e = torch.gather(state.eps_sorted, 1, posn[:, None])[:, 0]
    W = torch.tensor(state.W, device=dev)
    b32 = torch.tensor(state.b.astype(np.float32), device=dev)
    z = classify(W @ state.F[eid] - b32)
    posn, e, z = torch.stack([posn.double(), e.double(),
                              z.double()]).cpu().numpy()
    t = probe_partition(torch.from_numpy(e), torch.from_numpy(lw),
                        torch.from_numpy(hw)).numpy()
    posn = posn.astype(np.int64)
    lab = np.where(t != 0, t, z).astype(np.int8)
    if params.buffer_cap:
        in_buf = (state.buffer_lo <= posn) & (posn < state.buffer_hi)
    else:
        in_buf = np.zeros(t.shape, bool)
    tier = np.where(t != 0, TIER_WATER,
                    np.where(in_buf, TIER_BUFFER, TIER_DISK)).astype(np.int8)
    return state, lab, tier
