"""Parameter descriptors of the port, the counterpart of
`repro/models/params.py`.

Models are declared as nested dicts of `ParamSpec` (shape, dtype, logical
axes, init). `init_params` materializes them deterministically, one
`torch.Generator` per leaf seeded from the leaf's path exactly as the
reference seeds its `jax.random` keys (md5 of "seed:path"). The two
generators draw different numbers from the same seed, so parity tests carry
the reference's parameters across (`core/convert.py`) instead.

The logical axes map to the axes of a `launch.mesh.Mesh` by the
reference's rules (`LOGICAL_RULES_TP`, `LOGICAL_RULES_FSDP`, `RULE_SETS`,
`resolve_axes`, `partition_specs`): TP on "model", FSDP on "data", a
sharding dropped where the mesh's size does not divide the dimension. A
spec is a tuple with one entry a dimension: None, an axis name, or a
tuple of axis names (the reference's `PartitionSpec` entries). A rank
holds the block of a leaf that `block_slices` gives it, as a
`NamedSharding` places it (the major axis first).

The reference's `named_shardings` and `logical_sharding` attach layouts to
jax arrays for GSPMD; PyTorch has no tensor to attach them to, so their
work is done by the layers themselves (`models/layers.py`, `moe.py`,
`rwkv6.py`, `mamba.py`): under `with mesh:` (`current_mesh()`) each layer
reads its weights' specs, computes on its blocks and talks over the
mesh's groups through the differentiable collectives of `launch/mesh.py`.
Outside a mesh (`current_mesh()` is None) the layers run as on one
device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import current_mesh  # noqa: F401 (re-export)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float8_e4m3fn": torch.float8_e4m3fn}


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


# a leaf of more elements is drawn one slice of its leading axis at a
# time: drawn whole, its f32 draw and the scaled copy would need 8 bytes
# an element beside the parameters (llama4-scout's 12 stacked `we_in`
# need 64 GB that way on an 80 GB card)
WHOLE_DRAW_MAX = 1 << 30


def _init_leaf(spec: ParamSpec, gen: torch.Generator, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    shape = spec.shape
    if spec.init == "fan_in":
        fan_in = shape[0] if len(shape) <= 2 else math.prod(shape[:-1])
        std = spec.scale / max(1.0, float(fan_in)) ** 0.5
    else:  # normal
        std = 0.02 * spec.scale

    def draw(shape):
        v = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (v * std).to(spec.dtype)

    if math.prod(shape) <= WHOLE_DRAW_MAX:
        return draw(shape)
    out = torch.empty(shape, dtype=spec.dtype, device=device)
    for i in range(shape[0]):
        out[i] = draw(shape[1:])
    return out


def init_params(tree, seed: int = 0, device=None, mesh=None):
    """Materialize every leaf on `device` (None: the GPU; raises without
    one unless "cpu" is asked), each from its own generator (on that
    device) seeded by `_path_seed(path, seed)`; a leaf of more than
    `WHOLE_DRAW_MAX` elements one slice of its leading axis at a time.
    With `mesh`, each leaf is drawn whole and the rank keeps its block
    (the "tp" rules), one leaf at a time: the blocks are those of the
    whole tree `init_params` draws without a mesh."""
    device = resolve_device(device)

    def walk(node, path=""):
        if isinstance(node, ParamSpec):
            gen = torch.Generator(device=device)
            gen.manual_seed(_path_seed(path, seed))
            t = _init_leaf(node, gen, device)
            if mesh is None:
                return t
            return shard(t, resolve_axes(node.axes, node.shape, mesh,
                                         LOGICAL_RULES_TP), mesh)
        return {k: walk(v, f"{path}['{k}']") for k, v in node.items()}

    return walk(tree)


# ---------------------------------------------------------------------------
# Logical axis -> mesh axis rules (the reference's tables)
# ---------------------------------------------------------------------------

# Default "tp" rules: TP on `model`, FSDP on `data`, DP over `pod`+`data`.
LOGICAL_RULES_TP: Dict[Optional[str], Tuple[str, ...]] = {
    "vocab": ("model",),
    "embed": ("data",),            # d_model: FSDP-sharded on weights
    "heads": ("model",),
    "kv_heads": (),                # GQA kv head count rarely divides tp
    "head_dim": (),
    "kv_head_dim": ("model",),     # kv projections shard the head_dim instead
    "mlp": ("model",),
    "experts": ("model",),
    "expert_in": ("data",),
    "mamba_inner": ("model",),
    "rwkv_heads": ("model",),
    "layers": (),
    "conv": (),
    "state": (),
    "batch": ("pod", "data"),
    "act_heads": ("model",),
    "act_kv": (),
    "seq": (),
    "seq_sp": ("model",),          # the residual stream (seq_parallel)
    "kv_seq": ("model",),          # a decode KV cache's rows
    "long_kv_seq": ("data", "model"),
    "entity": ("pod", "data"),     # hazy view rows
    "feature": ("model",),         # hazy view feature dim
    None: (),
}

# "fsdp" rules for tiny models (the reference's: the same table)
LOGICAL_RULES_FSDP: Dict[Optional[str], Tuple[str, ...]] = dict(
    LOGICAL_RULES_TP,
    **{
        "vocab": ("model",),
        "embed": ("data",),
        "heads": ("model",),
        "mlp": ("model",),
    },
)

RULE_SETS = {"tp": LOGICAL_RULES_TP, "fsdp": LOGICAL_RULES_FSDP}

Spec = Tuple[Any, ...]      # a PartitionSpec's entries


def _mesh_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a port `Mesh` or of anything with `axis_names` and
    a `devices` array (a jax mesh)."""
    return dict(zip(mesh.axis_names, np.shape(mesh.devices)))


def resolve_axes(logical: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                 mesh, rules: Dict[Optional[str], Tuple[str, ...]]) -> Spec:
    """Map logical axes to a spec, dropping non-divisible shardings (the
    reference's function, over the mesh's names and shape only)."""
    mesh_axes = _mesh_sizes(mesh)
    used = set()
    out: List[Any] = []
    for dim, name in zip(shape, logical):
        picked, size = [], 1
        for ax in rules.get(name, ()):
            if ax not in mesh_axes or ax in used:
                continue
            if dim % (size * mesh_axes[ax]) == 0:
                picked.append(ax)
                size *= mesh_axes[ax]
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    return tuple(out)


# the residual stream between the layers (the reference's `_SP`):
# Megatron-style sequence parallelism over "model"
STREAM_AXES = ("batch", "seq_sp", None)


def seq_parallel(shape: Tuple[int, ...], mesh) -> bool:
    """Whether a residual stream of global `shape` (b, s, d) is split over
    "model" along its sequence on `mesh` (None: no mesh), by the
    reference's rule on `STREAM_AXES`: where "model" divides s (the rule
    drops the split elsewhere, as in decode at s = 1)."""
    if mesh is None:
        return False
    spec = resolve_axes(STREAM_AXES, tuple(shape), mesh, LOGICAL_RULES_TP)
    return "model" in spec_axes(spec[1])


def partition_specs(tree, mesh, rule_set: str = "tp"):
    """The spec of every `ParamSpec` leaf of `tree` on `mesh`."""
    rules = RULE_SETS[rule_set]
    return tree_map_specs(
        lambda s: resolve_axes(s.axes, s.shape, mesh, rules), tree)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sharded_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a leaf of `spec` is sharded on, sorted."""
    return tuple(sorted(a for e in spec for a in spec_axes(e)))


def block_slices(shape, spec: Spec, mesh) -> Tuple[slice, ...]:
    """This rank's block of a leaf of global `shape` under `spec`: on a
    dimension sharded over axes (a, b), block a·|b| + b of |a|·|b|, as a
    `NamedSharding` places it."""
    out = []
    for dim, entry in zip(shape, spec):
        axes = spec_axes(entry)
        n, i = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            i = i * mesh.shape[a] + mesh.coords[a]
        size = dim // n
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    return tuple(s.stop - s.start for s in block_slices(shape, spec, mesh))


def shard(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """A contiguous copy of this rank's block of the whole tensor `t`."""
    return t[block_slices(t.shape, spec, mesh)].contiguous().clone()


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A leaf of a state held in blocks over `mesh` (the reference's
    `ShapeDtypeStruct` with a `NamedSharding`): its spec, its global shape
    and dtype, and `local`, a meta tensor of the rank's block."""
    spec: Spec
    shape: Tuple[int, ...]
    dtype: torch.dtype
    local: torch.Tensor
    mesh: Any = dataclasses.field(repr=False, compare=False)

    @property
    def slices(self) -> Tuple[slice, ...]:
        return block_slices(self.shape, self.spec, self.mesh)


def sharded_spec(spec: "ParamSpec", mesh, rule_set: str = "tp") -> Sharded:
    ps = resolve_axes(spec.axes, spec.shape, mesh, RULE_SETS[rule_set])
    return Sharded(ps, tuple(spec.shape), spec.dtype,
                   torch.empty(local_shape(spec.shape, ps, mesh),
                               dtype=spec.dtype, device="meta"), mesh)
