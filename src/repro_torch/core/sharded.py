"""Device maintenance, counterpart of `repro.core.sharded`: on one GPU
with one row shard (`mesh=None`), or on a `launch.mesh.Mesh` of
`torch.distributed` ranks, each holding its block of the state. Two
engines:

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

On a mesh (`mesh=` of the drivers; every rank runs the same program) the
layout is the reference's: entity rows are sharded over ("pod", "data"),
each rank holding the contiguous block `NamedSharding(P(rows, ...))`
gives its coordinate, pod-major; for the single view the feature columns
are also split over "model". What crosses shards is reduced by
all-reduces over the mesh's groups (`launch.mesh.all_reduce`), in place
of the reference's psum and pmax:

  * single view: partial margins are summed over "model" (with "model" of
    size 1 the kernels run as on one shard; above 1 the banded step takes
    its window's partials from `eps_affine` with b = 0, since
    `band_reclassify` returns labels only); band widths are summed, and
    their max taken, over each row axis in the reference's order; the
    positive count is summed over the row axes;
  * k views: F rows stay whole (`P(rows, None)`), so the ranks along
    "model" hold the same rows and compute the same; the update step sums
    the widths and takes the max of the overflow flag over the row axes;
    the reorganize issues no collective; the hybrid probe and the entity
    margin take a masked row sum (gids == entity) summed over the row
    axes; counts are summed over the row axes.

Every rank runs the same host control on the reduced values (waters in
float64, SKIING, the overflow-forced reorganize), so all ranks reach the
same decisions without a broadcast.

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
from repro_torch.launch.mesh import Mesh, all_reduce, row_block


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------

def _split_model(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.shape.get("model", 1) > 1


def col_block(mesh: Optional[Mesh], d: int) -> slice:
    """This rank's block of the single view's d feature columns, split
    over "model" (`P(rows, "model")`). Raises unless "model" divides d."""
    parts = 1 if mesh is None else mesh.shape.get("model", 1)
    if d % parts:
        raise ValueError(f"{d} columns do not split into {parts} model "
                         "shards")
    size = d // parts
    c = 0 if parts == 1 else mesh.coords["model"]
    return slice(c * size, (c + 1) * size)


def reduce_rows(t: torch.Tensor, op: str, mesh: Optional[Mesh]):
    """`t` all-reduced IN PLACE over each row axis in turn (the
    reference's `for ax in rows: psum/pmax`)."""
    if mesh is not None:
        for ax in mesh.row_axes:
            all_reduce(t, op, mesh, ax)
    return t


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh], n: int):
    """(..., n_local) per rank -> (..., n) on every rank, rank blocks in
    the reference's global order (a zero-padded sum over the row axes;
    the ranks along "model" hold the same rows). The identity without a
    mesh. Signed zeros may lose their sign."""
    if mesh is None:
        return x
    rows = row_block(mesh, n)
    dt = torch.int32 if x.dtype in (torch.int8, torch.bool) else x.dtype
    out = torch.zeros(x.shape[:-1] + (n,), dtype=dt, device=x.device)
    out[..., rows] = x.to(dt)
    return reduce_rows(out, "sum", mesh).to(x.dtype)


def _margins(F, w, b, mesh: Optional[Mesh]):
    """(z, labels) for z = F·w − b over F's rows. With "model" above 1, F
    and w are the rank's column block: the partial dots (`eps_affine`
    with b = 0) are summed over "model", then b is subtracted."""
    if not _split_model(mesh):
        z, labels, _ = eps_affine(F, w, b)
        return z, labels
    part, _, _ = eps_affine(F, w, 0.0)
    z = all_reduce(part, "sum", mesh, "model") - b
    return z, classify(z)


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


def naive_update(state: ShardedHazyState, w, b, mesh: Optional[Mesh] = None
                 ) -> ShardedHazyState:
    """The naive eager step: labels <- sign(F·w − b) over all n rows in
    one `eps_affine` pass. Only `labels` changes: eps, the stored model
    and the waters stay as they were, as in the reference. On a mesh, w
    is the rank's column block."""
    _, labels = _margins(state.F, w, b, mesh)
    return state._replace(labels=labels)


def hazy_update(state: ShardedHazyState, w, b, *, cap: int,
                mesh: Optional[Mesh] = None):
    """The banded incremental step. Returns (state, wsum, wmax), host ints:
    the width hi − lo of the band [lo, hi), summed and its max taken over
    the row shards (one shard: both are the width). A band of at most
    `cap` rows is relabeled in place, exactly its rows, in one
    `band_reclassify` launch (with "model" above 1: its partial margins
    from `eps_affine`, summed over "model"). A wider band overflows the
    reference's `cap`-row window: its labels are left as they were and the
    caller must reorganize, which rewrites every label (the reference
    relabels the window's part of the band first, and that work is
    overwritten by the same reorganize)."""
    lo, hi = torch.stack(band_partition(state.eps, state.lw,
                                        state.hw)).tolist()
    width = hi - lo
    if width <= cap:
        if not _split_model(mesh):
            band_reclassify_rows(state.F, state.labels, w, b, lo, width)
        elif width:
            _, window = _margins(state.F[lo:hi], w, b, mesh)
            labels = state.labels           # relabeled in place, as the
            labels[lo:hi] = window          # kernel relabels it
    if mesh is None:
        return state, width, width
    widths = torch.tensor([width, width], dtype=torch.int64,
                          device=state.eps.device)
    for ax in mesh.row_axes:           # one upload, one read back
        all_reduce(widths[:1], "sum", mesh, ax)
        all_reduce(widths[1:], "max", mesh, ax)
    wsum, wmax = widths.tolist()
    return state, wsum, wmax


def reorganize(state: ShardedHazyState, w, b, mesh: Optional[Mesh] = None
               ) -> ShardedHazyState:
    """Fresh eps z = F·w − b through `eps_affine`, then a stable ascending
    sort of z (ties keep row order, so z ≡ 0 keeps the identity): F, perm,
    eps and labels are gathered in that order; the stored model becomes
    (w, b) and the waters reset to 0. On a mesh the sort is shard-local
    and the one collective is the sum of partial margins over "model"."""
    z, labels = _margins(state.F, w, b, mesh)
    order = argsort_stable(z)
    zero = torch.zeros((), dtype=torch.float32, device=z.device)
    return ShardedHazyState(state.F[order], z[order], labels[order],
                            state.perm[order], w, b, zero, zero)


def all_members(state: ShardedHazyState, mesh: Optional[Mesh] = None
                ) -> torch.Tensor:
    """The positive count, a () int32 tensor on the state's device (on a
    mesh summed over the row axes)."""
    c = (state.labels == 1).sum(dtype=torch.int32).reshape(1)
    return reduce_rows(c, "sum", mesh).reshape(())


@dataclasses.dataclass
class ShardedHazy:
    """Host driver for one view: Hölder waters on the host via
    `engine.waters_update`, SKIING over modeled costs (the band fraction
    of n), and a reorganize whenever the band outgrows `cap` rows
    (cap = max(64, int(n_local·cap_frac)), the reference's window on a
    shard of n_local rows). `device=None` means the GPU. With `mesh`, the
    state holds this rank's block of rows and columns (`row_block`,
    `col_block`) and `w_stored` the rank's columns of the stored model;
    the driver keeps the whole stored model on the host for the waters."""
    n: int
    d: int
    M: float
    p: float = 2.0
    alpha: float = 1.0
    cap_frac: float = 1 / 64
    device: Optional[object] = None
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        full_fp32()
        self.rows = row_block(self.mesh, self.n)
        self.cols = col_block(self.mesh, self.d)
        self.cap = max(64, int((self.rows.stop - self.rows.start)
                               * self.cap_frac))
        self.skiing = Skiing(S=1.0, alpha=self.alpha)
        self.lw = 0.0
        self.hw = 0.0
        self.overflows = 0        # band wider than cap -> forced reorg
        self.w_stored = np.zeros(self.d, np.float32)   # the whole, host

    def restore(self, lw: float, hw: float, skiing: Skiing,
                overflows: int, w_stored=None):
        """Continue from another driver's host state (see `core.convert`),
        with the whole stored model `w_stored` (default: zeros)."""
        self.lw, self.hw = float(lw), float(hw)
        self.skiing = skiing
        self.overflows = int(overflows)
        if w_stored is not None:
            self.w_stored = np.array(w_stored, np.float32)

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.tensor(x, device=self.device)       # always a copy

    def _model(self, w, b):
        """Host (w f32, b f32) and the device copies of the rank's columns
        of w and of b."""
        w32, b32 = np.asarray(w, np.float32), np.float32(b)
        return w32, b32, self._put(w32[self.cols]), self._put(b32)

    def init_state(self, F: np.ndarray) -> ShardedHazyState:
        """The state from the whole (n, d) table; the rank keeps its
        block."""
        rows, cols = self.rows, self.cols
        n = rows.stop - rows.start
        d = cols.stop - cols.start
        zero = self._put(np.zeros((), np.float32))
        state = ShardedHazyState(
            F=self._put(np.ascontiguousarray(F[rows, cols], np.float32)),
            eps=self._put(np.zeros(n, np.float32)),
            labels=self._put(np.ones(n, np.int8)),
            perm=self._put(np.arange(rows.start, rows.stop, dtype=np.int32)),
            w_stored=self._put(np.zeros(d, np.float32)),
            b_stored=zero, lw=zero, hw=zero)
        return self._do_reorg(state, self._put(np.zeros(d, np.float32)),
                              zero, np.zeros(self.d, np.float32),
                              record=False)

    def _do_reorg(self, state, wd, bd, w32, record=True):
        state = reorganize(state, wd, bd, self.mesh)
        self.w_stored = w32
        if record:
            self.skiing.record_reorg()
        self.lw = self.hw = 0.0
        return state

    def apply_model(self, state: ShardedHazyState, w, b) -> ShardedHazyState:
        """One eager round under SKIING (modeled costs ∝ rows touched).
        w (d,) and b are the host model; b is taken in f32, as the
        reference driver receives it."""
        w32, b32, wd, bd = self._model(w, b)
        if self.skiing.should_reorganize():
            return self._do_reorg(state, wd, bd, w32)
        lw, hw = waters_update(self.lw, self.hw, w32, float(b32),
                               self.w_stored,
                               float(state.b_stored), self.M, self.p)
        self.lw, self.hw = float(lw), float(hw)
        state, wsum, wmax = hazy_update(
            state._replace(lw=self._put(np.float32(self.lw)),
                           hw=self._put(np.float32(self.hw))),
            wd, bd, cap=self.cap, mesh=self.mesh)
        if wmax > self.cap:
            # the band outgrew the window: reorganize instead of shipping
            # stale labels (SKIING would reorganize soon anyway)
            self.overflows += 1
            return self._do_reorg(state, wd, bd, w32)
        self.skiing.record_incremental(wsum / self.n)     # modeled cost
        return state

    def apply_model_naive(self, state: ShardedHazyState, w, b
                          ) -> ShardedHazyState:
        """The paper's non-incremental baseline: relabel all n rows under
        (w, b). Touches neither the waters nor SKIING."""
        _, _, wd, bd = self._model(w, b)
        return naive_update(state, wd, bd, self.mesh)

    def all_members(self, state: ShardedHazyState) -> int:
        return int(all_members(state, self.mesh))

    def labels_in_entity_order(self, state: ShardedHazyState) -> np.ndarray:
        """(n,) int8 maintained labels indexed by entity id (on a mesh,
        every rank gets all n)."""
        if self.mesh is None:
            out = np.empty(self.n, np.int8)
            out[state.perm.cpu().numpy()] = state.labels.cpu().numpy()
            return out
        out = torch.zeros(self.n, dtype=torch.int32, device=self.device)
        out[state.perm.long()] = state.labels.to(torch.int32)
        return reduce_rows(out, "sum", self.mesh).cpu().numpy().astype(
            np.int8)


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


def _mv_tiles(mesh: Optional[Mesh], n: int, cap_frac: float):
    """Per-shard (n_local, block_n, cap) for the band kernel, the
    reference's arithmetic: block_n divides n_local (or is n_local), cap
    is tile-aligned in [block_n, n_local]."""
    n_local = n if mesh is None else n // mesh.size(mesh.row_axes)
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
                     block_n: int, mesh: Optional[Mesh] = None):
    """Banded incremental step for all k views in ONE kernel launch on
    the rank's shard. Relabels `state.labels` in place. Returns (state,
    true band widths (k,) i32, overflow () bool — some window exceeded
    the capacity on some shard, so rows past it keep stale labels and the
    driver must reorganize). On a mesh the widths are summed, and the
    overflow flag's max taken as int32, over each row axis."""
    start, end, width = covering_windows(state.eps, state.lw, state.hw)
    labels, overflow = multiview_band_reclassify(
        state.F, state.labels, W, b, start, end, cap=cap, block_n=block_n,
        with_overflow=True)
    if mesh is None:
        return state._replace(labels=labels), width, torch.any(overflow)
    ov = torch.any(overflow).to(torch.int32).reshape(1)
    for ax in mesh.row_axes:
        all_reduce(width, "sum", mesh, ax)
        all_reduce(ov, "max", mesh, ax)
    return state._replace(labels=labels), width, ov[0] != 0


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


def _masked_sum(state: ShardedMultiViewState, x: torch.Tensor,
                entity_id: int, mesh: Mesh) -> torch.Tensor:
    """Σ over the rank's rows of x[..., row] where gids == entity, summed
    over the row axes: the entity's column of x (k, n_local) wherever it
    lives (the other shards add exact zeros)."""
    hit = state.gids == entity_id
    e = torch.where(hit[None, :], x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device)).sum(dim=1)
    return reduce_rows(e, "sum", mesh)


def multiview_hybrid_probe(state: ShardedMultiViewState, entity_id: int,
                           mesh: Optional[Mesh] = None):
    """§3.5.2 waters short-circuit for ONE entity across all k views with
    zero feature bytes: its stored eps from the eps-map, then THE
    point-probe partition. Returns ((k,) int8 labels with 0 = unresolved,
    (k,) bool resolved, (k,) eps). On a mesh the eps come from a masked
    row sum over the row axes."""
    if mesh is None:
        e = state.eps[:, _position(state, entity_id)]
    else:
        e = _masked_sum(state, state.eps, entity_id, mesh)
    lab = probe_partition(e, state.lw, state.hw)
    return lab, lab != 0, e


def multiview_entity_margin(state: ShardedMultiViewState, W, b,
                            entity_id: int, mesh: Optional[Mesh] = None
                            ) -> torch.Tensor:
    """The "disk" fallback: ONE gather of the entity's feature row, then
    every view's margin under the current models. (k,) f32. On a mesh the
    row is a masked row sum (the reference's), the margins summed over
    the row axes before b is subtracted."""
    if mesh is None:
        f = state.F[_position(state, entity_id)]
        return W @ f - b
    hit = (state.gids == entity_id).to(state.F.dtype)
    z = W @ (hit @ state.F)
    return reduce_rows(z, "sum", mesh) - b


def multiview_all_members(state: ShardedMultiViewState,
                          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Positive counts (k,) int32, on a mesh summed over the row axes."""
    c = (state.labels == 1).sum(dim=1, dtype=torch.int32)
    return reduce_rows(c, "sum", mesh)


# ---------------------------------------------------------------------------
# k-view host driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedMultiViewHazy:
    """Host driver for k views: pooled SKIING (a reorganization re-sorts the
    one shared order for all views), per-view Hölder waters kept on the
    host via `engine.waters_update`. `apply_models` relabels the union
    band through the kernel and reorganizes whenever a covering window
    overflows the capacity. `device=None` means the GPU. With `mesh`, the
    state holds this rank's block of rows (`row_block`), whole rows, and
    the kernel's tiles are the shard's."""
    n: int
    d: int
    k: int
    M: float
    p: float = 2.0
    alpha: float = 1.0
    cap_frac: float = 1 / 64
    device: Optional[object] = None
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        full_fp32()
        self.rows = row_block(self.mesh, self.n)
        _, self.block_n, self.cap = _mv_tiles(self.mesh, self.n,
                                              self.cap_frac)
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
        """The state from the whole (n, d) table; the rank keeps its
        rows."""
        rows = self.rows
        k, n, d = self.k, rows.stop - rows.start, self.d
        zk = self._put(np.zeros(k, np.float32))
        state = ShardedMultiViewState(
            F=self._put(np.ascontiguousarray(F[rows], np.float32)),
            gids=self._put(np.arange(rows.start, rows.stop, dtype=np.int32)),
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
            block_n=self.block_n, mesh=self.mesh)
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
        return multiview_all_members(state, self.mesh).cpu().numpy()

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
        lab, resolved, _ = multiview_hybrid_probe(st, i, self.mesh)
        host = torch.stack([lab, resolved.to(torch.int8)]).cpu().numpy()
        lab, resolved = host[0].copy(), host[1].astype(bool)
        if not resolved.all():
            z = multiview_entity_margin(
                st, self._put(np.asarray(W, np.float32)),
                self._put(np.asarray(b, np.float32)), i, self.mesh)
            lab = np.where(resolved, lab,
                           classify(z).cpu().numpy()).astype(np.int8)
        return lab, resolved

    def labels_of(self, state: ShardedMultiViewState, entity_id: int):
        """(k,) int8 maintained labels of one entity."""
        i = self._entity(entity_id)
        if self.mesh is None:
            return state.labels[:, _position(state, i)].cpu().numpy()
        return _masked_sum(state, state.labels.to(torch.int32), i,
                           self.mesh).cpu().numpy().astype(np.int8)
