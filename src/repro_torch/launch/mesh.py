"""Meshes of the port over `torch.distributed`, the counterpart of
`repro/launch/mesh.py` with its names.

A `Mesh` is a named grid of the ranks of an initialised process group:
rank r sits at `np.unravel_index(r, shape)` (row-major, as
`jax.make_mesh` lays out devices), and every axis has process groups of
its own: the ranks that differ only in that axis's coordinate. The row
axes ("pod", "data") together also get one group, the data-parallel
group of the training step. Every rank builds the same groups in the
same order (`dist.new_group` is collective over the world), so every
rank must build the same meshes. ("data", "model") together get one too:
the axes a long-context decode cache splits its rows over.

The collectives of the port's mesh paths go through `all_reduce`,
`all_gather` and `reduce_scatter` here, which count them by (axes, op)
in `CALLS`, so a test can show which groups a step talks over, and add
the bytes of the buffer each hands to `dist.all_reduce` to `BYTES` (the
zero-padded whole for a gather, the full sum for a reduce-scatter).

`Mesh.abstract(shape, axes, rank)` is a mesh by shape alone, with no
process group: the dry run's (`launch/dryrun.py`), where the reference's
production meshes (16, 16) and (2, 16, 16) stand for 256 and 512 ranks
on one host. It has a live mesh's names, shape, grid and coordinates and
no groups; its collectives call no `dist` function, return results of
the right shape (of meta tensors, say) and record the calls and bytes a
live mesh's would.
`dist.all_reduce` is the one collective they call: gloo takes CUDA
tensors for all-reduce and broadcast only, and several ranks on one GPU
must run gloo (NCCL refuses two ranks on one device). So `all_gather` is
a sum of zero-padded blocks and `reduce_scatter` a sum sliced to the
rank's block. The tensor-parallel layers differentiate through them as
`torch.autograd.Function`s: `copy_to_group` (identity forward, sum
backward), `reduce_from_group` (sum forward, identity backward),
`gather_from_group` (gather forward, reduce-scatter backward; with
`same=True`, for ranks that all compute the same thing, the backward takes
the rank's block of the gradient instead), its adjoint `scatter_to_group`
(reduce-scatter forward, gather backward; with `same=True`, the rank's
block of a tensor every rank holds alike, the split) and
`sum_over_group` (sum both ways). Every rank calls the same collectives in
the same order: none depends on the data. An axis of size 1 calls nothing.

`with mesh:` makes a mesh the one the model code finds
(`current_mesh()`, re-exported by `models.params`), for a state whose
ranks hold their blocks: the layers then run tensor-parallel
(`state_mesh()`). `with mesh.replicated():` enters it for a state that
every rank holds whole: only the row-wise reductions (the MoE aux loss)
see it (`current_mesh()` gives either).

The residual stream between the layers is the reference's `("batch",
"seq_sp", None)`: under `with mesh:` it is split over "model" along its
sequence where the rule splits it (`models.params.seq_parallel` decides,
the model enters `with stream(split):`, and a layer asks
`stream_split()`), Megatron's sequence parallelism; elsewhere it is whole
on every rank. A tensor-parallel layer takes its normed input whole
through `from_stream` (the gather over "model", or on a whole stream
`copy_to_group`) and puts its partial sums back through `to_stream` (the
reduce-scatter, or `reduce_from_group`); a layer that computes whole and
alike on every rank passes `same=True` (the gather whose backward takes the
rank's block, and the split). `within_stream(fn)` binds a function to the
stream it is called in, for remat's recompute in the backward.

Importing this module touches no process-group state (the reference's
dry-run contract): the group starts in `init_process_group` and the
meshes are built inside the functions.
"""
from __future__ import annotations

import collections
import contextlib
import os
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

ROW_AXES = ("pod", "data")
LONG_KV = ("data", "model")    # a long-context decode cache's rows
OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
CALLS: "collections.Counter[Tuple[Tuple[str, ...], str]]" = (
    collections.Counter())
BYTES: "collections.Counter[Tuple[Tuple[str, ...], str]]" = (
    collections.Counter())
_TIMEOUT: Dict[str, timedelta] = {}      # the default group's, for subgroups
# the entered meshes, innermost last: (mesh, whether its ranks hold blocks)
_MESHES: List[Tuple["Mesh", bool]] = []
# the entered residual streams, innermost last: whether split over "model"
_STREAMS: List[bool] = []


def init_process_group(device=None, *, backend: Optional[str] = None,
                       init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       timeout: Optional[timedelta] = None) -> torch.device:
    """Start the default process group and return this rank's device.

    Without `init_method` the group starts from torchrun's environment
    (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`/`MASTER_PORT`); with one (say
    `file:///shared/rendezvous` or `tcp://localhost:29500`), `rank` and
    `world_size` default to `RANK` and `WORLD_SIZE`. `device=None` means
    the GPU (raises without one; `device="cpu"` runs on the host). The
    backend is NCCL on CUDA and gloo on the CPU unless `backend` names
    one: several ranks on one GPU name gloo, since NCCL refuses two
    ranks on one device. On CUDA each rank takes GPU `LOCAL_RANK` modulo
    the GPUs it sees."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if timeout is not None:
        kw["timeout"] = _TIMEOUT["group"] = timeout
    if init_method is None:
        init_method = "env://"
    else:
        kw["rank"] = int(os.environ["RANK"] if rank is None else rank)
        kw["world_size"] = int(os.environ["WORLD_SIZE"] if world_size is None
                               else world_size)
    if backend == "nccl" and dev.type == "cuda":
        kw["device_id"] = dev
    dist.init_process_group(backend=backend, init_method=init_method, **kw)
    return dev


class Mesh:
    """A named grid over the ranks of the default process group.

    `shape` maps each axis name to its size (as a jax mesh's `.shape`
    does), `axis_names` keeps their order, `devices` is the grid of
    ranks and `coords` this rank's coordinate on each axis.
    `is_abstract` is False for a mesh over a process group
    (`Mesh.abstract` builds the other kind)."""

    is_abstract = False

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        shape, axes = self._names(shape, axes)
        if not dist.is_initialized():
            raise RuntimeError("no process group: call "
                               "launch.mesh.init_process_group first")
        need, world = int(np.prod(shape)), dist.get_world_size()
        if world != need:
            raise ValueError(f"a mesh of shape {shape} over {axes} needs "
                             f"{need} ranks; the process group has {world}")
        self._place(shape, axes, dist.get_rank())
        self._groups = {}
        for key in [(a,) for a in axes] + (
                [self.row_axes] if len(self.row_axes) > 1 else []) + (
                [LONG_KV] if set(LONG_KV) <= set(axes) else []):
            self._groups[key] = self._new_groups(key)

    @staticmethod
    def _names(shape, axes):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes}")
        return shape, axes

    def _place(self, shape, axes, rank: int):
        self.axis_names = axes
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)
        self.rank = rank
        self.coords = dict(zip(axes, (int(c) for c in np.unravel_index(
            rank, shape))))
        self.row_axes = tuple(a for a in ROW_AXES if a in axes)

    @classmethod
    def abstract(cls, shape: Sequence[int], axes: Sequence[str],
                 rank: int = 0) -> "Mesh":
        """A mesh of `shape` over `axes` seen from `rank`, with no process
        group: the collectives record what they would send and call no
        `dist` function."""
        shape, axes = cls._names(shape, axes)
        if not 0 <= rank < int(np.prod(shape)):
            raise ValueError(f"rank {rank} outside a mesh of shape {shape}")
        mesh = cls.__new__(cls)
        mesh._place(shape, axes, int(rank))
        mesh._groups = {}
        mesh.is_abstract = True
        return mesh

    def _new_groups(self, key):
        """Build the groups of the axes in `key` (each rank's group holds
        the ranks that differ only in those coordinates) and return the
        one holding this rank."""
        idx = [self.axis_names.index(a) for a in key]
        rest = [i for i in range(len(self.axis_names)) if i not in idx]
        grid = np.transpose(self.devices, rest + idx).reshape(
            -1, int(np.prod([self.devices.shape[i] for i in idx])))
        mine = None
        for ranks in grid:
            group = dist.new_group([int(r) for r in ranks],
                                   timeout=_TIMEOUT.get("group"))
            if self.rank in ranks:
                mine = group
        return mine

    def group(self, axes) -> dist.ProcessGroup:
        """This rank's group over one axis name, or over a tuple of them
        (one axis, or the row axes together)."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        if self.is_abstract:
            raise RuntimeError(f"{self} is abstract: it has no groups")
        return self._groups[key]

    def size(self, axes) -> int:
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape[a] for a in key]))

    def index(self, axes) -> int:
        """This rank's position along `axes` taken together, the first
        axis major (a `NamedSharding` over ("pod", "data") gives the
        rank's block of rows this index)."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in key:
            i = i * self.shape[a] + self.coords[a]
        return i

    def __repr__(self):
        kind = ", abstract" if self.is_abstract else ""
        return f"Mesh({self.shape}, rank={self.rank}{kind})"

    def __enter__(self):
        _MESHES.append((self, True))
        return self

    def __exit__(self, *exc):
        _MESHES.pop()
        return False

    @contextlib.contextmanager
    def replicated(self):
        """Enter the mesh for a state every rank holds whole."""
        _MESHES.append((self, False))
        try:
            yield self
        finally:
            _MESHES.pop()


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost `with mesh:` or `with
    mesh.replicated():`, or None."""
    return _MESHES[-1][0] if _MESHES else None


def state_mesh() -> Optional[Mesh]:
    """The mesh whose ranks hold blocks of the state (`with mesh:`), or
    None (no mesh, or `with mesh.replicated():`)."""
    return _MESHES[-1][0] if _MESHES and _MESHES[-1][1] else None


@contextlib.contextmanager
def stream(split: bool):
    """Run the layers on a residual stream split over "model" along its
    sequence (`split`, as `models.params.seq_parallel` decides it) or
    whole."""
    _STREAMS.append(bool(split))
    try:
        yield
    finally:
        _STREAMS.pop()


def stream_split() -> bool:
    """Whether the innermost residual stream is split over "model" along
    its sequence: False outside `with stream(True):` or without a state
    mesh."""
    return bool(_STREAMS) and _STREAMS[-1] and state_mesh() is not None


def within_stream(fn):
    """`fn` run in the stream of this call wherever it is called later
    (remat's recompute runs in the backward, outside the forward's
    `with stream(...)`)."""
    split = bool(_STREAMS) and _STREAMS[-1]

    def run(*args, **kw):
        with stream(split):
            return fn(*args, **kw)
    return run


def _send(buf: torch.Tensor, name: str, op: str, mesh: Mesh, key):
    """The one `dist.all_reduce` of a collective, counted as (key, name)
    in `CALLS` and its buffer's bytes in `BYTES`; on an abstract mesh
    counted only."""
    CALLS[(key, name)] += 1
    BYTES[(key, name)] += buf.numel() * buf.element_size()
    if not mesh.is_abstract:
        dist.all_reduce(buf, op=OPS[op], group=mesh.group(key))


def all_reduce(t: torch.Tensor, op: str, mesh: Mesh, axes) -> torch.Tensor:
    """`dist.all_reduce` of `t` IN PLACE over this rank's group along
    `axes` with op "sum" or "max"; counted in `CALLS` and `BYTES`.
    Returns `t`."""
    _send(t, op, op, mesh, _key(axes))
    return t


def _key(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _bits(t: torch.Tensor):
    """(an integer tensor whose sum with zeros keeps `t`'s bits, the
    function back): a sum of zero-padded floats would turn -0.0 into 0.0."""
    if not t.is_floating_point():
        return t, lambda x: x
    wide = {2: torch.int32, 4: torch.int32, 8: torch.int64}[t.element_size()]
    narrow = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()]
    dtype = t.dtype
    return (t.view(narrow).to(wide),
            lambda x: x.to(narrow).view(dtype))


def all_gather(t: torch.Tensor, mesh: Mesh, axes, dim: int,
               exact: bool = False) -> torch.Tensor:
    """The blocks of `t` along `dim` from the ranks of this rank's group
    over `axes` (an axis or a tuple, major first), concatenated in their
    order: one all-reduce of the zero-padded whole. `exact` sums the
    bits as integers (checkpoints: -0.0 and NaN kept); counted in `CALLS`
    as (axes, "all_gather")."""
    key = _key(axes)
    n = mesh.size(key)
    if n == 1:
        return t
    size = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = size * n
    i = mesh.index(key)
    src, back = _bits(t) if exact else (t, lambda x: x)
    out = torch.zeros(shape, dtype=src.dtype, device=t.device)
    out.narrow(dim, i * size, size).copy_(src)
    _send(out, "all_gather", "sum", mesh, key)
    return back(out)


def reduce_scatter(t: torch.Tensor, mesh: Mesh, axes,
                   dim: int) -> torch.Tensor:
    """This rank's block along `dim` of the sum of `t` over its group on
    `axes`: one all-reduce, then a slice; counted as (axes,
    "reduce_scatter")."""
    key = _key(axes)
    n = mesh.size(key)
    if n == 1:
        return t
    out = t.contiguous().clone()
    _send(out, "reduce_scatter", "sum", mesh, key)
    size = t.shape[dim] // n
    return out.narrow(dim, mesh.index(key) * size, size).contiguous()


def _block(t: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    n = mesh.size(axes)
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.index(axes) * size, size).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), "sum", ctx.mesh,
                          ctx.axes), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x.contiguous().clone(), "sum", mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, same):
        ctx.mesh, ctx.axes, ctx.dim, ctx.same = mesh, axes, dim, same
        return all_gather(x.contiguous(), mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.same:
            out = _block(g, ctx.mesh, ctx.axes, ctx.dim)
        else:
            out = reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim)
        return out, None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, same):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        if same:
            return _block(x, mesh, axes, dim)
        return reduce_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim),
                None, None, None, None)


def copy_to_group(x, mesh: Mesh, axes="model"):
    """Identity forward; the gradient summed over the group backward: a
    value every rank holds alike, entering a computation the ranks split
    between them."""
    return x if mesh.size(axes) == 1 else _Copy.apply(x, mesh, _key(axes))


def reduce_from_group(x, mesh: Mesh, axes="model"):
    """The sum over the group forward (each rank's partial result);
    identity backward."""
    return x if mesh.size(axes) == 1 else _Reduce.apply(x, mesh, _key(axes))


def sum_over_group(x, mesh: Mesh, axes):
    """The sum over the group both ways (the adjoint of an SPMD sum): a
    row-wise statistic made global, whose gradient each rank sums."""
    return copy_to_group(reduce_from_group(x, mesh, axes), mesh, axes)


def gather_from_group(x, mesh: Mesh, axes, dim: int, same: bool = False):
    """The blocks of the group along `dim` forward; the gradient's block
    of the sum over the group backward (`same`: the ranks computed the
    same gradient, and the rank takes its block of its own)."""
    if mesh.size(axes) == 1:
        return x
    return _Gather.apply(x, mesh, _key(axes), dim, same)


def scatter_to_group(x, mesh: Mesh, axes, dim: int, same: bool = False):
    """The rank's block along `dim` of the sum over the group forward (each
    rank's partial result; `same`: of `x` itself, which every rank holds
    alike, the split); the gradient gathered backward."""
    if mesh.size(axes) == 1:
        return x
    return _Scatter.apply(x, mesh, _key(axes), dim, same)


def from_stream(x, mesh: Optional[Mesh], same: bool = False):
    """The positions of the residual stream's tensor `x` (b, s, ...)
    whole on this rank, entering a layer on "model": on a split stream
    gathered over "model" (the backward reduce-scatters the ranks' partial
    gradients; with `same`, for a layer every rank computes whole and
    alike, takes the rank's block of its own), on a whole stream through
    `copy_to_group` (with `same`, as it is). Without a mesh, `x`."""
    if mesh is None:
        return x
    if stream_split():
        return gather_from_group(x, mesh, "model", 1, same)
    return x if same else copy_to_group(x, mesh)


def to_stream(y, mesh: Optional[Mesh], same: bool = False):
    """A layer's output `y` (b, s, ...) over every position, back in the
    residual stream's layout: each rank's partial sum reduce-scattered
    over "model" onto the rank's positions on a split stream, summed on a
    whole one; with `same` (every rank holds `y` alike) the rank's
    positions, or `y` as it is. Without a mesh, `y`."""
    if mesh is None:
        return y
    if stream_split():
        return scatter_to_group(y, mesh, "model", 1, same)
    return y if same else reduce_from_group(y, mesh)


def row_block(mesh: Optional[Mesh], n: int) -> slice:
    """This rank's contiguous block of `n` rows sharded over the row axes,
    pod-major, as `NamedSharding(P(("pod", "data")))` lays them out.
    Raises unless the row shards divide n."""
    if mesh is None:
        return slice(0, n)
    shards = mesh.size(mesh.row_axes)
    if n % shards:
        raise ValueError(f"{n} rows do not split into {shards} row shards")
    size = n // shards
    i = mesh.index(mesh.row_axes)
    return slice(i * size, (i + 1) * size)


def make_mesh(shape, axes, *, abstract: bool = False, rank: int = 0) -> Mesh:
    """A mesh over the process group, or with `abstract` one by shape
    alone seen from `rank`."""
    return Mesh.abstract(shape, axes, rank) if abstract else Mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False, abstract: bool = False,
                         rank: int = 0) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, abstract=abstract, rank=rank)


def make_elastic_mesh(num_devices: int, *, model_parallel: int = 16) -> Mesh:
    """The mesh of the ranks left after a failure, relaunched as a world
    of `num_devices`: the model axis keeps its degree (a property of the
    checkpointed layout), the data axis shrinks."""
    if num_devices % model_parallel:
        raise ValueError(f"{num_devices} ranks do not split into model "
                         f"groups of {model_parallel}")
    return Mesh((num_devices // model_parallel, model_parallel),
                ("data", "model"))


def make_host_mesh(shape=(1, 1), axes=("data", "model")) -> Mesh:
    """A small mesh over the ranks of this host (tests, CPU examples)."""
    return make_mesh(shape, axes)
