"""A layer's weights on the state mesh: the work the reference leaves to
`logical_sharding` and GSPMD, done by hand.

Under `with mesh:` every rank holds its block of each leaf, laid out by
`params.partition_specs`. A layer builds `Blocks` over its params and
the function that declares its `ParamSpec` tree (the declaration its
params came from; the specs are resolved once for each mesh and set of
arguments) and asks for each weight as it needs it:

  * `local(key)`: the dimensions sharded over an axis other than "model"
    (the FSDP "embed" and "expert_in" on "data") gathered, through
    `gather_from_group`, whose backward reduce-scatters the gradient: the
    sum over the row shards arrives on the rank that owns the block. The
    "model" blocks stay the rank's own: the tensor-parallel forms compute
    on them.
  * `whole(key)`: every dimension gathered; over "model" with
    `same=True`, for a layer whose sizes the model degree does not divide
    and which then computes whole and alike on every rank (the
    reference's own rule: `resolve_axes` left its activations unsharded).
  * `shared(key)`: `local` then `copy_to_group` over "model": a weight the
    ranks hold alike but use in a computation they split between them, so
    each rank's gradient of it is a part to be summed.
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict

from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.params import partition_specs, spec_axes

MODEL = "model"
_SPECS: "weakref.WeakKeyDictionary[mesh_lib.Mesh, Dict]" = (
    weakref.WeakKeyDictionary())


def layer_specs(mesh, make_specs: Callable, *args, **kw) -> Dict:
    """`partition_specs(make_specs(*args, **kw), mesh)`, resolved once for
    each mesh and arguments (a config is a frozen dataclass)."""
    cache = _SPECS.setdefault(mesh, {})
    key = (make_specs, args, tuple(sorted(kw.items())))
    if key not in cache:
        cache[key] = partition_specs(make_specs(*args, **kw), mesh)
    return cache[key]


class Blocks:
    def __init__(self, mesh, p: Dict, make_specs: Callable, *args, **kw):
        self.mesh = mesh
        self.specs = layer_specs(mesh, make_specs, *args, **kw)
        self.p = p

    def on_model(self, key: str, dim: int) -> bool:
        return MODEL in spec_axes(self.specs[key][dim])

    def _gather(self, key: str, skip_model: bool):
        t = self.p[key]
        for dim, entry in enumerate(self.specs[key]):
            for ax in reversed(spec_axes(entry)):        # minor axis first
                if ax != MODEL:
                    t = mesh_lib.gather_from_group(t, self.mesh, ax, dim)
                elif not skip_model:
                    t = mesh_lib.gather_from_group(t, self.mesh, ax, dim,
                                                   same=True)
        return t

    def local(self, key: str):
        return self._gather(key, skip_model=True)

    def whole(self, key: str):
        return self._gather(key, skip_model=False)

    def shared(self, key: str):
        return mesh_lib.copy_to_group(self.local(key), self.mesh)

    def all_whole(self) -> Dict:
        """Every weight of the layer whole (the replicated form)."""
        return {key: (v if isinstance(v, dict) else self.whole(key))
                for key, v in self.p.items()}

    @property
    def model_size(self) -> int:
        return self.mesh.size(MODEL)

    @property
    def model_index(self) -> int:
        return self.mesh.coords[MODEL]
