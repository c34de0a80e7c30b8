"""Device maintenance on one GPU, counterpart of `repro.core.sharded`, with
one row shard and no mesh. Two engines:

Single view (`ShardedHazyState`, its steps, the `ShardedHazy` driver): the
paper's own algorithm. The entity rows sit on the device in eps-sorted
order (`perm`: position -> entity id), so the Lemma 3.1 band is one
contiguous run of rows. The steps:

  * `naive_update` — relabel every row under the current model through the
                     `eps_affine` kernel (the paper's naive eager baseline);
  * `hazy_update`  — locate the band [lo, hi) (`engine.band_partition`) and
                     relabel exactly its rows through the single-view
                     `band_reclassify` kernel (the incremental step);
  * `reorganize`   — fresh eps through `eps_affine`, a stable sort of eps
                     itself, rows, perm, eps and labels gathered together;
  * `all_members`  — the positive count.

k views (`ShardedMultiViewState`, its steps, `ShardedMultiViewHazy`): k
one-vs-all views share ONE scratch table kept on the device in a SHARED
clustering order: rows sorted by min_v |eps_v|, the distance to the
nearest view's decision boundary, so every view's Lemma 3.1 band is a
small covering window near the front of the table. `gids` is the
permutation (position -> entity id). The steps:

  * `multiview_update`     — per-view covering windows of the band
                             (`engine.covering_windows`) and ONE launch of
                             the `multiview_band_reclassify` kernel over
                             their union; reports the true band widths and
                             whether some window overflowed the capacity;
  * `multiview_reorganize` — re-sort the shared order from one F·Wᵀ
                             product; rows, gids, eps and labels move
                             together;
  * `multiview_hybrid_probe` / `multiview_entity_margin` — the §3.5.2 read
                             pair: waters short-circuit from the eps-map,
                             then one feature-row gather for the views the
                             waters cannot resolve;
  * `multiview_all_members` — positive counts per view.

The host drivers keep the Eq. 2 waters (numpy float64) and SKIING, with
the same host round trips as the reference drivers. The products outside
the kernels (the k-view reorganize, margins) must run in full fp32: under
TF32 the stored eps would be off by about 1e-3 relative and the Lemma 3.1
partition would stop being exact, so the drivers switch TF32 off.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.engine import (argsort_stable, band_partition,
                                     classify, covering_windows,
                                     probe_partition, waters_update)
from repro_torch.core.skiing import Skiing
from repro_torch.device import full_fp32, resolve_device
from repro_torch.kernels.band_reclassify.ops import (
    band_reclassify_rows, multiview_band_reclassify)
from repro_torch.kernels.eps_affine.ops import eps_affine


# ---------------------------------------------------------------------------
# single view
# ---------------------------------------------------------------------------

class ShardedHazyState(NamedTuple):
    """One view over the entity rows, kept in eps-sorted order."""
    F: torch.Tensor          # (n, d) f32 rows in eps-sorted order
    eps: torch.Tensor        # (n,) f32 stored-model eps (the eps-map)
    labels: torch.Tensor     # (n,) int8
    perm: torch.Tensor       # (n,) i32 position -> entity id
    w_stored: torch.Tensor   # (d,) f32
    b_stored: torch.Tensor   # () f32 (the reference stores f32 too)
    lw: torch.Tensor         # () f32
    hw: torch.Tensor         # () f32


def naive_update(state: ShardedHazyState, w, b) -> ShardedHazyState:
    """The naive eager step: labels <- sign(F·w − b) over all n rows in
    one `eps_affine` pass. Only `labels` changes: eps, the stored model
    and the waters stay as they were, as in the reference."""
    _, labels, _ = eps_affine(state.F, w, b)
    return state._replace(labels=labels)


def hazy_update(state: ShardedHazyState, w, b, *, cap: int):
    """The banded incremental step. Returns (state, wsum, wmax), host ints,
    where wsum = wmax = hi − lo is the width of the band [lo, hi) (one
    shard). A band of at most `cap` rows is relabeled in place, exactly
    its rows, in one `band_reclassify` launch. A wider band overflows the
    reference's `cap`-row window: its labels are left as they were and the
    caller must reorganize, which rewrites every label (the reference
    relabels the window's part of the band first, and that work is
    overwritten by the same reorganize)."""
    lo, hi = torch.stack(band_partition(state.eps, state.lw,
                                        state.hw)).tolist()
    width = hi - lo
    if width <= cap:
        band_reclassify_rows(state.F, state.labels, w, b, lo, width)
    return state, width, width


def reorganize(state: ShardedHazyState, w, b) -> ShardedHazyState:
    """Fresh eps z = F·w − b through `eps_affine`, then a stable ascending
    sort of z (ties keep row order, so z ≡ 0 keeps the identity): F, perm,
    eps and labels are gathered in that order; the stored model becomes
    (w, b) and the waters reset to 0."""
    z, labels, _ = eps_affine(state.F, w, b)
    order = argsort_stable(z)
    zero = torch.zeros((), dtype=torch.float32, device=z.device)
    return ShardedHazyState(state.F[order], z[order], labels[order],
                            state.perm[order], w, b, zero, zero)


def all_members(state: ShardedHazyState) -> torch.Tensor:
    """The positive count, a () int32 tensor on the state's device."""
    return (state.labels == 1).sum(dtype=torch.int32)


@dataclasses.dataclass
class ShardedHazy:
    """Host driver for one view: Hölder waters on the host via
    `engine.waters_update`, SKIING over modeled costs (the band fraction
    of n), and a reorganize whenever the band outgrows `cap` rows
    (cap = max(64, int(n·cap_frac)), the reference's window).
    `device=None` means the GPU."""
    n: int
    d: int
    M: float
    p: float = 2.0
    alpha: float = 1.0
    cap_frac: float = 1 / 64
    device: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        full_fp32()
        self.cap = max(64, int(self.n * self.cap_frac))
        self.skiing = Skiing(S=1.0, alpha=self.alpha)
        self.lw = 0.0
        self.hw = 0.0
        self.overflows = 0        # band wider than cap -> forced reorg

    def restore(self, lw: float, hw: float, skiing: Skiing,
                overflows: int):
        """Continue from another driver's host state (see `core.convert`)."""
        self.lw, self.hw = float(lw), float(hw)
        self.skiing = skiing
        self.overflows = int(overflows)

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.tensor(x, device=self.device)       # always a copy

    def _model(self, w, b):
        """Host (w f32, b f32) and their device copies."""
        w32, b32 = np.asarray(w, np.float32), np.float32(b)
        return w32, b32, self._put(w32), self._put(b32)

    def init_state(self, F: np.ndarray) -> ShardedHazyState:
        n, d = self.n, self.d
        zero = self._put(np.zeros((), np.float32))
        state = ShardedHazyState(
            F=self._put(np.ascontiguousarray(F, np.float32)),
            eps=self._put(np.zeros(n, np.float32)),
            labels=self._put(np.ones(n, np.int8)),
            perm=self._put(np.arange(n, dtype=np.int32)),
            w_stored=self._put(np.zeros(d, np.float32)),
            b_stored=zero, lw=zero, hw=zero)
        return reorganize(state, self._put(np.zeros(d, np.float32)), zero)

    def _do_reorg(self, state, wd, bd):
        state = reorganize(state, wd, bd)
        self.skiing.record_reorg()
        self.lw = self.hw = 0.0
        return state

    def apply_model(self, state: ShardedHazyState, w, b) -> ShardedHazyState:
        """One eager round under SKIING (modeled costs ∝ rows touched).
        w (d,) and b are the host model; b is taken in f32, as the
        reference driver receives it."""
        w32, b32, wd, bd = self._model(w, b)
        if self.skiing.should_reorganize():
            return self._do_reorg(state, wd, bd)
        lw, hw = waters_update(self.lw, self.hw, w32, float(b32),
                               state.w_stored.cpu().numpy(),
                               float(state.b_stored), self.M, self.p)
        self.lw, self.hw = float(lw), float(hw)
        state, wsum, wmax = hazy_update(
            state._replace(lw=self._put(np.float32(self.lw)),
                           hw=self._put(np.float32(self.hw))),
            wd, bd, cap=self.cap)
        if wmax > self.cap:
            # the band outgrew the window: reorganize instead of shipping
            # stale labels (SKIING would reorganize soon anyway)
            self.overflows += 1
            return self._do_reorg(state, wd, bd)
        self.skiing.record_incremental(wsum / self.n)     # modeled cost
        return state

    def apply_model_naive(self, state: ShardedHazyState, w, b
                          ) -> ShardedHazyState:
        """The paper's non-incremental baseline: relabel all n rows under
        (w, b). Touches neither the waters nor SKIING."""
        _, _, wd, bd = self._model(w, b)
        return naive_update(state, wd, bd)

    def all_members(self, state: ShardedHazyState) -> int:
        return int(all_members(state))

    def labels_in_entity_order(self, state: ShardedHazyState) -> np.ndarray:
        """(n,) int8 maintained labels indexed by entity id."""
        out = np.empty(self.n, np.int8)
        out[state.perm.cpu().numpy()] = state.labels.cpu().numpy()
        return out


# ---------------------------------------------------------------------------
# k views
# ---------------------------------------------------------------------------

class ShardedMultiViewState(NamedTuple):
    """k views sharing one scratch table in a shared clustering order."""
    F: torch.Tensor          # (n, d) f32 scratch rows, shared order
    gids: torch.Tensor       # (n,) i32 entity id per scratch row
    eps: torch.Tensor        # (k, n) f32 stored-model margins, shared order
    labels: torch.Tensor     # (k, n) int8 aligned to the shared order
    W_stored: torch.Tensor   # (k, d) f32
    b_stored: torch.Tensor   # (k,) f32 (the reference stores f32 too)
    lw: torch.Tensor         # (k,) f32
    hw: torch.Tensor         # (k,) f32


def _mv_tiles(n: int, cap_frac: float):
    """(n_local, block_n, cap) for the band kernel on one row shard:
    block_n divides n, cap is tile-aligned in [block_n, n]."""
    n_local = n
    block_n = 512
    while block_n > 8 and n_local % block_n:
        block_n //= 2
    if n_local % block_n:
        block_n = n_local
    cap = -(-max(block_n, int(n_local * cap_frac)) // block_n) * block_n
    return n_local, block_n, min(cap, n_local)


# ---------------------------------------------------------------------------
# k-view steps (plain functions of the state; no host sync inside)
# ---------------------------------------------------------------------------

def multiview_update(state: ShardedMultiViewState, W, b, *, cap: int,
                     block_n: int):
    """Banded incremental step for all k views in ONE kernel launch.
    Relabels `state.labels` in place. Returns (state, true band widths
    (k,) i32, overflow () bool — some window exceeded the capacity, so
    rows past it keep stale labels and the driver must reorganize)."""
    start, end, width = covering_windows(state.eps, state.lw, state.hw)
    labels, overflow = multiview_band_reclassify(
        state.F, state.labels, W, b, start, end, cap=cap, block_n=block_n,
        with_overflow=True)
    return state._replace(labels=labels), width, torch.any(overflow)


def multiview_reorganize(state: ShardedMultiViewState, W, b
                         ) -> ShardedMultiViewState:
    """Re-sort the shared clustering order by min_v |eps_v| from one F·Wᵀ
    product (stable, as the reference's argsort) and reset the stored
    models and waters."""
    Z = W @ state.F.T - b[:, None]                    # (k, n) fresh eps
    order = argsort_stable(torch.amin(torch.abs(Z), dim=0))
    eps = Z[:, order]
    zeros = torch.zeros_like(b)
    return ShardedMultiViewState(state.F[order], state.gids[order], eps,
                                 classify(eps), W, b, zeros, zeros)


def _position(state: ShardedMultiViewState, entity_id: int) -> torch.Tensor:
    """Scratch position of an entity, as a device scalar (no sync)."""
    return torch.argmax((state.gids == entity_id).to(torch.uint8))


def multiview_hybrid_probe(state: ShardedMultiViewState, entity_id: int):
    """§3.5.2 waters short-circuit for ONE entity across all k views with
    zero feature bytes: its stored eps from the eps-map, then THE
    point-probe partition. Returns ((k,) int8 labels with 0 = unresolved,
    (k,) bool resolved, (k,) eps)."""
    e = state.eps[:, _position(state, entity_id)]
    lab = probe_partition(e, state.lw, state.hw)
    return lab, lab != 0, e


def multiview_entity_margin(state: ShardedMultiViewState, W, b,
                            entity_id: int) -> torch.Tensor:
    """The "disk" fallback: ONE gather of the entity's feature row, then
    every view's margin under the current models. (k,) f32."""
    f = state.F[_position(state, entity_id)]
    return W @ f - b


def multiview_all_members(state: ShardedMultiViewState) -> torch.Tensor:
    return (state.labels == 1).sum(dim=1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# k-view host driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedMultiViewHazy:
    """Host driver for k views: pooled SKIING (a reorganization re-sorts the
    one shared order for all views), per-view Hölder waters kept on the
    host via `engine.waters_update`. `apply_models` relabels the union
    band through the kernel and reorganizes whenever a covering window
    overflows the capacity. `device=None` means the GPU."""
    n: int
    d: int
    k: int
    M: float
    p: float = 2.0
    alpha: float = 1.0
    cap_frac: float = 1 / 64
    device: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        full_fp32()
        _, self.block_n, self.cap = _mv_tiles(self.n, self.cap_frac)
        self.skiing = Skiing(S=1.0, alpha=self.alpha)
        self.lw = np.zeros(self.k, np.float64)
        self.hw = np.zeros(self.k, np.float64)
        self.overflows = 0        # kernel-capacity overflow -> forced reorg

    def restore(self, lw, hw, skiing: Skiing, overflows: int):
        """Continue from another driver's host state: waters (float64),
        SKIING and the overflow count (see `core.convert`)."""
        self.lw = np.array(lw, np.float64)
        self.hw = np.array(hw, np.float64)
        self.skiing = skiing
        self.overflows = int(overflows)

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.tensor(x, device=self.device)       # always a copy

    def init_state(self, F: np.ndarray) -> ShardedMultiViewState:
        k, n, d = self.k, self.n, self.d
        zk = self._put(np.zeros(k, np.float32))
        state = ShardedMultiViewState(
            F=self._put(np.ascontiguousarray(F, np.float32)),
            gids=self._put(np.arange(n, dtype=np.int32)),
            eps=self._put(np.zeros((k, n), np.float32)),
            labels=self._put(np.ones((k, n), np.int8)),
            W_stored=self._put(np.zeros((k, d), np.float32)),
            b_stored=zk, lw=zk, hw=zk)
        return multiview_reorganize(
            state, self._put(np.zeros((k, d), np.float32)), zk)

    def _do_reorg(self, state, W, b):
        state = multiview_reorganize(state, W, b)
        self.skiing.record_reorg()
        self.lw[:] = 0.0
        self.hw[:] = 0.0
        return state

    def _waters_on_device(self, state):
        return state._replace(lw=self._put(self.lw.astype(np.float32)),
                              hw=self._put(self.hw.astype(np.float32)))

    def apply_models(self, state: ShardedMultiViewState, W, b):
        """One eager round for all k views (modeled costs ∝ rows touched).
        W (k, d) and b (k,) are the host models (b float64)."""
        W32 = np.asarray(W, np.float32)
        Wd = self._put(W32)
        b32 = self._put(np.asarray(b, np.float32))
        if self.skiing.should_reorganize():
            return self._do_reorg(state, Wd, b32)
        self.lw, self.hw = waters_update(
            self.lw, self.hw, W32, np.asarray(b, np.float64),
            state.W_stored.cpu().numpy(),
            state.b_stored.cpu().numpy().astype(np.float64), self.M, self.p)
        state, wsum, overflow = multiview_update(
            self._waters_on_device(state), Wd, b32, cap=self.cap,
            block_n=self.block_n)
        if bool(overflow):
            # some view's covering window outgrew the kernel capacity: its
            # labels past the capacity are stale — rebuild the shared order
            # instead of shipping them
            self.overflows += 1
            return self._do_reorg(state, Wd, b32)
        self.skiing.record_incremental(
            float(np.sum(wsum.cpu().numpy())) / (self.n * self.k))
        return state

    def all_members(self, state) -> np.ndarray:
        return multiview_all_members(state).cpu().numpy()

    def _entity(self, entity_id) -> int:
        i = int(entity_id)
        if not 0 <= i < self.n:
            raise IndexError(f"entity {i} out of range [0, {self.n})")
        return i

    def hybrid_labels_of(self, state: ShardedMultiViewState, W, b,
                         entity_id: int):
        """§3.5.2 batched single-entity read: the device-side waters probe
        resolves what it can with zero feature bytes; the views that miss
        share ONE feature-row gather. Returns ((k,) int8 labels, (k,) bool
        resolved-by-water mask)."""
        i = self._entity(entity_id)
        st = self._waters_on_device(state)
        lab, resolved, _ = multiview_hybrid_probe(st, i)
        host = torch.stack([lab, resolved.to(torch.int8)]).cpu().numpy()
        lab, resolved = host[0].copy(), host[1].astype(bool)
        if not resolved.all():
            z = multiview_entity_margin(
                st, self._put(np.asarray(W, np.float32)),
                self._put(np.asarray(b, np.float32)), i)
            lab = np.where(resolved, lab,
                           classify(z).cpu().numpy()).astype(np.int8)
        return lab, resolved

    def labels_of(self, state: ShardedMultiViewState, entity_id: int):
        """(k,) int8 maintained labels of one entity."""
        i = self._entity(entity_id)
        return state.labels[:, _position(state, i)].cpu().numpy()
