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
the same host round trips as the reference drivers, but for the k-view
point read on one shard: it is resolved on the host from an index of
scratch positions, one read back of the entity's eps. The k-view driver
takes an optional `obs.Tracer` (`tracer=`): armed, its round, reads and
set-up open spans (`driver.round`, `read.probe`, `build.upload`, ...),
each blocking host↔device transfer is a `<where>.sync` span, and each
launch's windows are held on the device until the tracer's snapshot
counts their union rows in `kernels.union_rows` (one read of them all);
unarmed, every such site is one `is None` test (`traced`, `host_sync`)
and the transfers and device operations are those of the untraced code. The products outside
the kernels (the k-view reorganize, margins) must run in full fp32: under
TF32 the stored eps would be off by about 1e-3 relative and the Lemma 3.1
partition would stop being exact, so the drivers switch TF32 off.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.engine import (argsort_stable, band_partition,
                                     classify, covering_windows,
                                     host_probe_partition, probe_partition,
                                     waters_update)
from repro_torch.core.skiing import Skiing
from repro_torch.device import full_fp32, resolve_device
from repro_torch.kernels.band_reclassify.ops import (
    band_reclassify_rows, multiview_band_reclassify, window_union_rows)
from repro_torch.kernels.eps_affine.ops import eps_affine
from repro_torch.launch.mesh import Mesh, all_reduce, row_block
from repro_torch.obs.trace import Tracer

_UNTRACED = contextlib.nullcontext()


def traced(tracer: Optional[Tracer], name: str, **attrs):
    """`tracer.span(name, **attrs)`, or, with no tracer armed, a shared
    context that does nothing."""
    return _UNTRACED if tracer is None else tracer.span(name, **attrs)


def host_sync(tracer: Optional[Tracer], where: str, what: str, fn, *args):
    """`fn(*args)`, one blocking host↔device transfer. Armed, it is timed
    as a `<where>.sync` span (attribute `what`), whose histogram counts the
    transfers; unarmed, it is the bare call."""
    if tracer is None:
        return fn(*args)
    with tracer.span(where + ".sync", what=what):
        return fn(*args)


def union_rows_of(windows) -> int:
    """Rows of each launch's window union, summed over `windows`, a list
    of (start blocks, widths, block_n) as `multiview_update` returns them
    and the block size: the tensors read in one transfer."""
    host = torch.stack([t for sb, wd, _ in windows
                        for t in (sb, wd)]).cpu().tolist()
    return sum(window_union_rows(host[2 * i], host[2 * i + 1], bn)
               for i, (_, _, bn) in enumerate(windows))


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


def hazy_update_window(state: ShardedHazyState, w, b, *, cap: int,
                       mesh: Optional[Mesh] = None):
    """The banded step at the reference's static window, for a state whose
    band edges cannot be read on the host (meta tensors: the dry run,
    `launch/dryrun.py`): the band is located on the device as in
    `hazy_update`, then `cap` rows from the first are relabeled in one
    `band_reclassify` (with "model" above 1, their partial margins from
    `eps_affine`, summed over "model"), as the reference's jit step
    relabels a `cap`-row window wherever the band lies; the widths are
    summed, and their max taken, over each row axis. Returns (state,
    widths (2,) int64: sum and max)."""
    lo, hi = band_partition(state.eps, state.lw, state.hw)
    if not _split_model(mesh):
        band_reclassify_rows(state.F, state.labels, w, b, 0, cap)
    else:
        _, window = _margins(state.F[:cap], w, b, mesh)
        labels = state.labels           # relabeled in place, as the
        labels[:cap] = window           # kernel relabels it
    widths = torch.stack([hi - lo, hi - lo])
    if mesh is not None:
        for ax in mesh.row_axes:
            all_reduce(widths[:1], "sum", mesh, ax)
            all_reduce(widths[1:], "max", mesh, ax)
    return state, widths


def state_specs(n: int, d: int, mesh: Mesh, dtype=torch.bfloat16
                ) -> ShardedHazyState:
    """The reference's dry-run state (`repro.core.sharded.state_specs`):
    a `ShardedHazyState` of `Sharded` leaves, rows over ("pod", "data"),
    F's columns and w over "model", the scalars whole; each leaf's
    `.local` a meta tensor of the rank's block."""
    from repro_torch.models.params import Sharded, local_shape
    rows = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    r = rows[0] if len(rows) == 1 else (rows or None)
    model = "model" if "model" in mesh.axis_names else None

    def sds(shape, dt, spec):
        return Sharded(spec, shape, dt, torch.empty(
            local_shape(shape, spec, mesh), dtype=dt, device="meta"), mesh)

    return ShardedHazyState(
        F=sds((n, d), dtype, (r, model)),
        eps=sds((n,), torch.float32, (r,)),
        labels=sds((n,), torch.int8, (r,)),
        perm=sds((n,), torch.int32, (r,)),
        w_stored=sds((d,), torch.float32, (model,)),
        b_stored=sds((), torch.float32, ()),
        lw=sds((), torch.float32, ()),
        hw=sds((), torch.float32, ()))


def window_cap(n: int, mesh: Optional[Mesh], cap_frac: float = 1 / 64
               ) -> int:
    """The reference's static band window of its jit step: max(64,
    n_local · cap_frac) rows of the rank's n_local."""
    shards = 1 if mesh is None else mesh.size(mesh.row_axes)
    return max(64, int(n // shards * cap_frac))


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
    driver must reorganize — and the launch's aligned, clamped windows,
    the device pair ((k,) i32 start blocks, (k,) i32 widths) of the
    rank's shard). On a mesh the widths are summed, and the overflow
    flag's max taken as int32, over each row axis."""
    start, end, width = covering_windows(state.eps, state.lw, state.hw)
    labels, overflow, windows = multiview_band_reclassify(
        state.F, state.labels, W, b, start, end, cap=cap, block_n=block_n,
        with_overflow=True, with_windows=True)
    if mesh is None:
        return (state._replace(labels=labels), width, torch.any(overflow),
                windows)
    ov = torch.any(overflow).to(torch.int32).reshape(1)
    for ax in mesh.row_axes:
        all_reduce(width, "sum", mesh, ax)
        all_reduce(ov, "max", mesh, ax)
    return state._replace(labels=labels), width, ov[0] != 0, windows


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


def _masked_sum(state: ShardedMultiViewState, x: torch.Tensor,
                entity_id: int, mesh: Optional[Mesh]) -> torch.Tensor:
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
    (k,) bool resolved, (k,) eps). The eps come from a masked row sum
    (on a mesh summed over the row axes), all on the device; the one-shard
    driver reads them from its host index instead."""
    e = _masked_sum(state, state.eps, entity_id, mesh)
    lab = probe_partition(e, state.lw, state.hw)
    return lab, lab != 0, e


def multiview_entity_margin(state: ShardedMultiViewState, W, b,
                            entity_id: int, mesh: Optional[Mesh] = None
                            ) -> torch.Tensor:
    """The "disk" fallback: ONE gather of the entity's feature row, then
    every view's margin under the current models. (k,) f32. The row is a
    masked row sum (the reference's), the margins summed over the row
    axes of a mesh before b is subtracted."""
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
    the kernel's tiles are the shard's.

    Each blocking host↔device transfer is one host sync (a copy from
    pageable memory waits for the stream, as a read back does): an
    incremental round makes 8 (uploads of W, b and of the two waters;
    reads of the stored models, of the overflow flag and of the widths),
    a round that overflows 7, a SKIING reorganization 2. On one shard a
    point read is resolved on the host: 1 transfer, or 4 where the
    waters leave a view unresolved, and the first read of a new shared
    order 1 more (see `hybrid_labels_of`); on a mesh 3, or 6. With
    `tracer` (an `obs.Tracer`) each is a `driver.sync` or `read.sync`
    span; see the module's docstring."""
    n: int
    d: int
    k: int
    M: float
    p: float = 2.0
    alpha: float = 1.0
    cap_frac: float = 1 / 64
    device: Optional[object] = None
    mesh: Optional[Mesh] = None
    tracer: Optional[Tracer] = None

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
        # one shard: (the gids tensor, its inverse entity id -> scratch
        # position), one attribute so that a reader sees a matching pair
        self._index: Optional[tuple] = None

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
        with traced(self.tracer, "build.upload"):
            zk = self._put(np.zeros(k, np.float32))
            state = ShardedMultiViewState(
                F=self._put(np.ascontiguousarray(F[rows], np.float32)),
                gids=self._put(np.arange(rows.start, rows.stop,
                                         dtype=np.int32)),
                eps=self._put(np.zeros((k, n), np.float32)),
                labels=self._put(np.ones((k, n), np.int8)),
                W_stored=self._put(np.zeros((k, d), np.float32)),
                b_stored=zk, lw=zk, hw=zk)
            W0 = self._put(np.zeros((k, d), np.float32))
        with traced(self.tracer, "build.reorganize"):
            return multiview_reorganize(state, W0, zk)

    def _do_reorg(self, state, W, b):
        with traced(self.tracer, "driver.reorganize"):
            state = multiview_reorganize(state, W, b)
        self.skiing.record_reorg()
        self.lw[:] = 0.0
        self.hw[:] = 0.0
        return state

    def _waters_on_device(self, state, where: str):
        tr = self.tracer
        return state._replace(
            lw=host_sync(tr, where, "lw", self._put,
                         self.lw.astype(np.float32)),
            hw=host_sync(tr, where, "hw", self._put,
                         self.hw.astype(np.float32)))

    def apply_models(self, state: ShardedMultiViewState, W, b):
        """One eager round for all k views (modeled costs ∝ rows touched).
        W (k, d) and b (k,) are the host models (b float64). Armed, the
        round is a `driver.round` span whose `kind` is "incremental",
        "reorg" (SKIING's) or "overflow" (a window outgrew the capacity)."""
        with traced(self.tracer, "driver.round") as sp:
            state, kind = self._round(state, W, b)
            if sp is not None:
                sp.attrs["kind"] = kind
        return state

    def _round(self, state, W, b):
        tr = self.tracer
        W32 = np.asarray(W, np.float32)
        Wd = host_sync(tr, "driver", "W", self._put, W32)
        b32 = host_sync(tr, "driver", "b", self._put,
                        np.asarray(b, np.float32))
        if self.skiing.should_reorganize():
            return self._do_reorg(state, Wd, b32), "reorg"
        W_stored = host_sync(tr, "driver", "W_stored", torch.Tensor.cpu,
                             state.W_stored)
        b_stored = host_sync(tr, "driver", "b_stored", torch.Tensor.cpu,
                             state.b_stored)
        with traced(tr, "driver.waters"):
            self.lw, self.hw = waters_update(
                self.lw, self.hw, W32, np.asarray(b, np.float64),
                W_stored.numpy(), b_stored.numpy().astype(np.float64),
                self.M, self.p)
        state = self._waters_on_device(state, "driver")
        with traced(tr, "driver.relabel"):
            state, wsum, overflow, windows = multiview_update(
                state, Wd, b32, cap=self.cap, block_n=self.block_n,
                mesh=self.mesh)
        if tr is not None:     # held on the device, read at the snapshot
            tr.defer("kernels.union_rows", (*windows, self.block_n),
                     union_rows_of)
        if host_sync(tr, "driver", "overflow", bool, overflow):
            # some view's covering window outgrew the kernel capacity: its
            # labels past the capacity are stale — rebuild the shared order
            # instead of shipping them
            self.overflows += 1
            return self._do_reorg(state, Wd, b32), "overflow"
        wsum = host_sync(tr, "driver", "wsum", torch.Tensor.cpu, wsum)
        self.skiing.record_incremental(
            float(np.sum(wsum.numpy())) / (self.n * self.k))
        return state, "incremental"

    def all_members(self, state) -> np.ndarray:
        return multiview_all_members(state, self.mesh).cpu().numpy()

    def _entity(self, entity_id) -> int:
        i = int(entity_id)
        if not 0 <= i < self.n:
            raise IndexError(f"entity {i} out of range [0, {self.n})")
        return i

    def _position(self, state: ShardedMultiViewState, i: int) -> int:
        """Scratch position of entity `i` on one shard, from the host
        index `pos[gids] = arange(n)`. The index is rebuilt whenever
        `state.gids` is not the tensor it was built from (a reorganization
        makes a new one, a round keeps it): one read back of gids, a
        `read.sync` "gids", counted in `read.index_builds`."""
        index = self._index
        if index is None or index[0] is not state.gids:
            tr = self.tracer
            gids = host_sync(tr, "read", "gids", torch.Tensor.cpu,
                             state.gids).numpy()
            pos = np.empty(gids.shape[0], np.int32)
            pos[gids] = np.arange(gids.shape[0], dtype=np.int32)
            self._index = index = (state.gids, pos)
            if tr is not None:
                tr.count("read.index_builds")
        return int(index[1][i])

    def hybrid_labels_of(self, state: ShardedMultiViewState, W, b,
                         entity_id: int):
        """§3.5.2 batched single-entity read: the waters resolve what they
        can with zero feature bytes; the views that miss share ONE
        feature-row gather. Returns ((k,) int8 labels, (k,) bool
        resolved-by-water mask).

        One shard: the entity's position from the host index
        (`_position`), its k stored margins read back in one transfer and
        partitioned on the host against the driver's waters
        (`host_probe_partition`, bit for bit the device form on the f32
        waters); the gather is the row at that position, its margins
        W·f − b on the device. A mesh: the device-side probe over masked row sums, after
        uploads of the waters."""
        i = self._entity(entity_id)
        tr = self.tracer
        if self.mesh is None:
            with traced(tr, "read.probe"):
                p = self._position(state, i)
                e = host_sync(tr, "read", "eps", torch.Tensor.cpu,
                              state.eps[:, p]).numpy()
                lab = host_probe_partition(e, self.lw, self.hw)
            resolved = lab != 0

            def margin(Wd, bd):
                return Wd @ state.F[p] - bd
        else:
            st = self._waters_on_device(state, "read")
            with traced(tr, "read.probe"):
                lab, resolved, _ = multiview_hybrid_probe(st, i, self.mesh)
                both = torch.stack([lab, resolved.to(torch.int8)])
            host = host_sync(tr, "read", "probe", torch.Tensor.cpu,
                             both).numpy()
            lab, resolved = host[0].copy(), host[1].astype(bool)

            def margin(Wd, bd):
                return multiview_entity_margin(st, Wd, bd, i, self.mesh)
        if not resolved.all():
            with traced(tr, "read.gather"):
                Wd = host_sync(tr, "read", "W", self._put,
                               np.asarray(W, np.float32))
                bd = host_sync(tr, "read", "b", self._put,
                               np.asarray(b, np.float32))
                z = host_sync(tr, "read", "z", torch.Tensor.cpu,
                              classify(margin(Wd, bd)))
            lab = np.where(resolved, lab, z.numpy()).astype(np.int8)
        return lab, resolved

    def labels_of(self, state: ShardedMultiViewState, entity_id: int):
        """(k,) int8 maintained labels of one entity (a copy: on the CPU
        a view would follow the rounds' in-place relabels)."""
        i = self._entity(entity_id)
        if self.mesh is None:
            p = self._position(state, i)
            return state.labels[:, p].cpu().numpy().copy()
        return _masked_sum(state, state.labels.to(torch.int32), i,
                           self.mesh).cpu().numpy().astype(np.int8)
