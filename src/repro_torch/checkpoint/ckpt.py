"""Checkpoints of the port in the reference's on-disk format, the
counterpart of `repro/checkpoint/ckpt.py` with its names.

Layout:  <dir>/step_<n>.tmp/  -> one `leaf_<i>.npy` per leaf + an fsync'd
manifest.json -> rename to <dir>/step_<n>/ (atomic commit: a crash
mid-write never corrupts the latest complete checkpoint — the
fault-tolerance contract `launch/train.py` relies on). The manifest is
`{"step", "shard_id": 0, "leaves": [{"path", "dtype", "shape", "file"}]}`.

The format is the reference's byte for byte, so a checkpoint written by
either package restores in the other: leaves in `jax.tree_util`'s order
(dict keys sorted at every level), each path the string `jax.tree_util.
keystr` gives it (`['params']['blocks']['pos0']['attn']['wq']`), dtype
names numpy's (`bfloat16`, `float32`, `int32`), a bf16 leaf saved as its
uint16 bits and read back without `ml_dtypes`. The port's trees are
nested dicts of tensors (`models.steps.init_train_state`'s).

Restore takes the abstract state (`models.steps.train_state_specs`' meta
tensors, or any tree of tensors of the right shapes and dtypes) and puts
each leaf on one device; the params are marked to require grad, as
`init_train_state` marks them. One process writes whole tensors with
`shard_id` 0, as the reference's single-process path does. Under a
`torch.distributed` process group the state is replicated (the port's
training step is data-parallel), so global rank 0 alone writes, through
`save_checkpoint` and `AsyncCheckpointer`, while the others wait at a
barrier (`save_checkpoint`, `AsyncCheckpointer.wait`); every rank
restores. The format is the same whatever the world size.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

_BF16 = "bfloat16"


def _leafname(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _flatten(tree, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(keystr path, leaf) pairs in `jax.tree_util.tree_flatten_with_path`
    order: a dict's keys sorted, `[<repr of key>]` a level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    raise TypeError(f"checkpoint leaf {path or 'tree'} is a "
                    f"{type(tree).__name__}, not a tensor")


def _unflatten(like, leaves):
    """A tree of `like`'s dict structure holding `leaves` in `_flatten`'s
    order."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)
    return walk(like)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` in host memory that nothing else writes: `.cpu()` of
    a CPU tensor is the tensor itself, which the train step updates in
    place."""
    return t.detach().to("cpu", copy=True)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array `np.save` writes, numpy's dtype name)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    arr = t.numpy()
    return arr, arr.dtype.name


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _writer() -> bool:
    """True on the one process that writes: global rank 0, or the only
    process when no process group is running."""
    return not dist.is_initialized() or dist.get_rank() == 0


_thread = threading.local()      # .writer: an AsyncCheckpointer's thread


def _barrier():
    """Every rank waits for the others (no-op without a process group, and
    on an `AsyncCheckpointer`'s writer thread, whose `wait` and `close`
    take the barrier on the caller's thread instead)."""
    if dist.is_initialized() and not getattr(_thread, "writer", False):
        dist.barrier()


def save_checkpoint(directory: str, state, step: int) -> str:
    """Synchronous atomic save. Returns the committed path. Under a
    process group every rank calls it: rank 0 writes, and all return
    after a barrier, once the checkpoint is committed."""
    final = os.path.join(directory, f"step_{step:08d}")
    if _writer():
        _write(directory, final, state, step)
    _barrier()
    return final


def _write(directory: str, final: str, state, step: int):
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "shard_id": 0, "leaves": []}
    for i, (path, leaf) in enumerate(_flatten(state)):
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, _leafname(i)), arr)
        manifest["leaves"].append({
            "path": path,
            "dtype": dtype,
            "shape": list(np.shape(arr)),
            "file": _leafname(i),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, abstract_state,
                       step: Optional[int] = None, device=None):
    """Restore the tree of `abstract_state` (meta tensors or tensors: only
    shapes and dtypes are read) from `step` (None: the latest) onto
    `device` (None: the GPU; raises without one unless "cpu" is asked).
    The leaves under `params` require grad. Raises where a leaf is missing
    or its dtype or shape differs. Returns (state, step)."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}
    leaves = []
    for key, ab in _flatten(abstract_state):
        if key not in by_path:
            raise KeyError(f"{key} is not in {path}")
        meta = by_path[key]
        arr = np.load(os.path.join(path, meta["file"]))
        t = _from_numpy(arr, meta["dtype"])
        if t.dtype != ab.dtype or tuple(t.shape) != tuple(ab.shape):
            raise ValueError(f"{key}: {meta['dtype']} {list(t.shape)} in "
                             f"the checkpoint, {ab.dtype} "
                             f"{list(ab.shape)} expected")
        leaf = t.to(dev)
        if key.startswith("['params']"):
            leaf.requires_grad_(True)
        leaves.append(leaf)
    return _unflatten(abstract_state, leaves), manifest["step"]


class AsyncCheckpointer:
    """Background-thread checkpointing: the train loop hands off host copies
    and keeps stepping while the previous save commits (compute/IO
    overlap). The copies are taken in `save`, before it returns: the port's
    train step updates the state's tensors in place. Under a process
    group only global rank 0 copies and writes; `wait` and `close` end
    with a barrier on every rank, so a checkpoint is committed for all
    once they return."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._writes = _writer()
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        _thread.writer = True
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            state_host, step = item
            try:
                save_checkpoint(self.directory, state_host, step)
                self._gc()
            except BaseException as e:  # surfaced on next save()/close()
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, state, step: int):
        if self._err:
            raise self._err
        if not self._writes:
            return
        # snapshot to host memory before the next step writes the state
        host = _unflatten(state, [_host(t) for _, t in _flatten(state)])
        self._q.put((host, step))  # blocks only if a save is already queued

    def wait(self):
        self._q.join()
        _barrier()
        if self._err:
            raise self._err

    def close(self):
        self._q.put(None)
        self._t.join(timeout=60)
        _barrier()
        if self._err:
            raise self._err
