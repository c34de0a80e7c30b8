"""Meshes of the port over `torch.distributed`, the counterpart of
`repro/launch/mesh.py` with its names.

A `Mesh` is a named grid of the ranks of an initialised process group:
rank r sits at `np.unravel_index(r, shape)` (row-major, as
`jax.make_mesh` lays out devices), and every axis has process groups of
its own: the ranks that differ only in that axis's coordinate. The row
axes ("pod", "data") together also get one group, the data-parallel
group of the training step. Every rank builds the same groups in the
same order (`dist.new_group` is collective over the world), so every
rank must build the same meshes.

The collectives of the port's mesh paths go through `all_reduce` here,
which counts them by (axis, op) in `CALLS`, so a test can show which
groups a step talks over. `dist.all_reduce` is the one collective they
use: gloo takes CUDA tensors for all-reduce and broadcast only, and
several ranks on one GPU must run gloo (NCCL refuses two ranks on one
device).

Importing this module touches no process-group state (the reference's
dry-run contract): the group starts in `init_process_group` and the
meshes are built inside the functions.
"""
from __future__ import annotations

import collections
import os
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

ROW_AXES = ("pod", "data")
OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
CALLS: "collections.Counter[Tuple[Tuple[str, ...], str]]" = (
    collections.Counter())
_TIMEOUT: Dict[str, timedelta] = {}      # the default group's, for subgroups


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
    ranks and `coords` this rank's coordinate on each axis."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes}")
        if not dist.is_initialized():
            raise RuntimeError("no process group: call "
                               "launch.mesh.init_process_group first")
        need, world = int(np.prod(shape)), dist.get_world_size()
        if world != need:
            raise ValueError(f"a mesh of shape {shape} over {axes} needs "
                             f"{need} ranks; the process group has {world}")
        self.axis_names = axes
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.devices = np.arange(need).reshape(shape)
        self.rank = dist.get_rank()
        self.coords = dict(zip(axes, (int(c) for c in np.unravel_index(
            self.rank, shape))))
        self.row_axes = tuple(a for a in ROW_AXES if a in axes)
        self._groups = {}
        for key in [(a,) for a in axes] + (
                [self.row_axes] if len(self.row_axes) > 1 else []):
            self._groups[key] = self._new_groups(key)

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
        return f"Mesh({self.shape}, rank={self.rank})"


def all_reduce(t: torch.Tensor, op: str, mesh: Mesh, axes) -> torch.Tensor:
    """`dist.all_reduce` of `t` IN PLACE over this rank's group along
    `axes` with op "sum" or "max"; counted in `CALLS`. Returns `t`."""
    key = (axes,) if isinstance(axes, str) else tuple(axes)
    CALLS[(key, op)] += 1
    dist.all_reduce(t, op=OPS[op], group=mesh.group(key))
    return t


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


def make_mesh(shape, axes) -> Mesh:
    return Mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


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
