"""The port's logical-axis rules (`repro_torch.models.params`) against the
reference's (`repro.models.params`): `resolve_axes` and `partition_specs`
of every leaf of the param tree and the AdamW tree of all ten registered
configs, at full size, on the meshes (4, 2), (2, 4), (16, 16) and
(2, 16, 16). Both read only a mesh's axis names and shape, so a stand-in
with `axis_names` and a `devices` array of the mesh's shape serves both
sides (no devices). Then the blocks `block_slices` gives the ranks tile
every leaf evenly, major axis first."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config              # noqa: E402
from repro.models import build as jax_build                     # noqa: E402
from repro.models import params as JP                           # noqa: E402
from repro.optim.optimizers import opt_specs as jax_opt_specs   # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.configs.registry import ARCHS                  # noqa: E402
from repro_torch.models import build                            # noqa: E402
from repro_torch.models import params as TP                     # noqa: E402
from repro_torch.optim import opt_specs                         # noqa: E402

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _leaves(tree, is_spec, path=""):
    if is_spec(tree):
        return [(path, tree)]
    return [x for k in sorted(tree) for x in _leaves(tree[k], is_spec,
                                                      f"{path}/{k}")]


def _trees(arch):
    port = build(get_config(arch)).param_tree
    ref = jax_build(jax_config(arch)).param_tree
    return ({"params": port, "opt": opt_specs(port)},
            {"params": ref, "opt": jax_opt_specs(ref)})


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_resolve_axes_equals_the_reference(arch, mesh):
    port, ref = _trees(arch)
    m = _stand_in(*MESHES[mesh])
    got = _leaves(port, lambda x: isinstance(x, TP.ParamSpec))
    want = _leaves(ref, lambda x: isinstance(x, JP.ParamSpec))
    assert [p for p, _ in got] == [p for p, _ in want]
    sharded = 0
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.axes == w.axes, path
        for rules in ("tp", "fsdp"):
            mine = TP.resolve_axes(g.axes, g.shape, m, TP.RULE_SETS[rules])
            theirs = JP.resolve_axes(w.axes, w.shape, m,
                                     JP.RULE_SETS[rules])
            assert mine == tuple(theirs), (path, rules, mine, theirs)
        sharded += any(e is not None for e in mine)
    assert sharded > 0
    mine = _leaves(TP.partition_specs(port["params"], m),
                   lambda x: isinstance(x, tuple))
    theirs = _leaves(JP.partition_specs(ref["params"], m),
                     lambda x: not isinstance(x, dict))
    assert [(p, s) for p, s in mine] == [(p, tuple(s)) for p, s in theirs]


def test_rule_tables_equal_the_reference():
    assert TP.LOGICAL_RULES_TP == JP.LOGICAL_RULES_TP
    assert TP.LOGICAL_RULES_FSDP == JP.LOGICAL_RULES_FSDP
    assert sorted(TP.RULE_SETS) == sorted(JP.RULE_SETS)


@pytest.mark.parametrize("shape,axes,spec", [
    ((4, 2), ("data", "model"), ("data", None, "model")),
    ((4, 2), ("data", "model"), (("data", "model"), None, None)),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), "model", None)),
    ((2, 4), ("data", "model"), (None, None, None)),
])
def test_blocks_tile_every_leaf_once(shape, axes, spec):
    """The ranks' `block_slices` (row-major coordinates, the major axis
    first within a dimension) cover the leaf evenly, each element once for
    every rank that differs only on the axes the leaf is not sharded on,
    and the block of a dimension sharded over (a, b) is block a·|b| + b."""
    leaf = (16, 6, 8)
    hits = np.zeros(leaf, np.int64)
    for r in range(int(np.prod(shape))):
        coords = dict(zip(axes, np.unravel_index(r, shape)))
        m = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                  coords={a: int(c) for a, c in
                                          coords.items()})
        sl = TP.block_slices(leaf, spec, m)
        hits[sl] += 1
        assert TP.local_shape(leaf, spec, m) == hits[sl].shape
        for dim, entry in enumerate(spec):
            ax = TP.spec_axes(entry)
            i = 0
            for a in ax:
                i = i * m.shape[a] + m.coords[a]
            assert sl[dim].start == i * (leaf[dim] // int(np.prod(
                [m.shape[a] for a in ax] or [1])))
    sizes = dict(zip(axes, shape))
    copies = int(np.prod(shape)) // int(np.prod(
        [sizes[a] for a in TP.sharded_axes(spec)] or [1]))
    assert (hits == copies).all()
