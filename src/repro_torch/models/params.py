"""Parameter descriptors of the port, the counterpart of
`repro/models/params.py`.

Models are declared as nested dicts of `ParamSpec` (shape, dtype, logical
axes, init). `init_params` materializes them deterministically, one
`torch.Generator` per leaf seeded from the leaf's path exactly as the
reference seeds its `jax.random` keys (md5 of "seed:path"). The two
generators draw different numbers from the same seed, so parity tests carry
the reference's parameters across (`core/convert.py`) instead.

The logical axes are kept for the reference's sharding rules; on one GPU
they map to nothing, so the mesh rules (`resolve_axes`,
`logical_sharding`, ...) wait for the `torch.distributed` slice.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a config string ("bfloat16") or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in DTYPES:
        raise ValueError(f"no torch dtype for {dtype!r}")
    return DTYPES[dtype]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: Any = torch.bfloat16
    axes: Tuple[Optional[str], ...] = ()
    init: str = "normal"  # normal | zeros | ones | fan_in
    scale: float = 1.0

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not match shape "
                             f"{self.shape}")
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))


def tree_map_specs(fn: Callable, tree):
    """`fn` applied to every `ParamSpec` leaf of a nested dict."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    return {k: tree_map_specs(fn, v) for k, v in tree.items()}


def _path_seed(path: str, base: int) -> int:
    h = hashlib.md5(f"{base}:{path}".encode()).digest()
    return int.from_bytes(h[:4], "little")


def _init_leaf(spec: ParamSpec, gen: torch.Generator, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    v = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    if spec.init == "fan_in":
        shape = spec.shape
        fan_in = shape[0] if len(shape) <= 2 else math.prod(shape[:-1])
        std = spec.scale / max(1.0, float(fan_in)) ** 0.5
    else:  # normal
        std = 0.02 * spec.scale
    return (v * std).to(spec.dtype)


def init_params(tree, seed: int = 0, device=None):
    """Materialize every leaf on `device` (None: the GPU; raises without
    one unless "cpu" is asked), each from its own generator (on that
    device) seeded by `_path_seed(path, seed)`."""
    device = resolve_device(device)

    def walk(node, path=""):
        if isinstance(node, ParamSpec):
            gen = torch.Generator(device=device)
            gen.manual_seed(_path_seed(path, seed))
            return _init_leaf(node, gen, device)
        return {k: walk(v, f"{path}['{k}']") for k, v in node.items()}

    return walk(tree)
