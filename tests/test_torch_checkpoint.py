"""The port's checkpoints (`repro_torch.checkpoint`) and straggler logic
(`repro_torch.distributed`) against the JAX package's, on the CPU.

The analogs of tests/test_checkpoint_optim_data.py's round trip, async
checkpointer with its garbage collection, and restart equivalence (the
tinyllama smoke twin trained 6 steps, against 3, a checkpoint, a restore
and 3 more: bit for bit); the async snapshot taken before the next
in-place step changes the state. Across the packages, on every smoke
twin's train state: a checkpoint the reference writes restores in the
port equal to `train_state_from_reference`; one the port writes restores
in the reference equal to the reference's state; and for the same state
the two directories are byte for byte equal (manifest.json and every
leaf file). Then tests/test_distributed.py's two straggler tests against
the port's classes, and the two packages' detectors and assigners side
by side on a seeded stream of step times."""
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402

from repro import checkpoint as jax_ckpt                    # noqa: E402
from repro import distributed as jax_dist                   # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS                # noqa: E402
from repro.configs import smoke_config as jax_smoke         # noqa: E402
from repro.models import build as jax_build                 # noqa: E402
from repro.models import steps as JS                        # noqa: E402

from repro_torch.checkpoint import (AsyncCheckpointer, ckpt,  # noqa: E402
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import smoke_config                # noqa: E402
from repro_torch.core.convert import train_state_from_reference  # noqa: E402
from repro_torch.data import TokenStream                    # noqa: E402
from repro_torch.distributed import (ShardAssigner,         # noqa: E402
                                     StragglerDetector)
from repro_torch.models import build                        # noqa: E402
from repro_torch.models.steps import (init_train_state,     # noqa: E402
                                      make_train_step, train_state_specs)
from repro_torch.optim import tree_leaves                   # noqa: E402


def _tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones((2, 2), dtype=torch.bfloat16),
                   "c": torch.tensor(3, dtype=torch.int32)},
    }


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _same(a, b):
    """Equal trees of tensors: dtypes, shapes and bits."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.detach(), y.detach())


def test_checkpoint_roundtrip(tmp_path):
    state = _tree()
    save_checkpoint(str(tmp_path), state, 7)
    assert latest_step(str(tmp_path)) == 7
    restored, step = restore_checkpoint(str(tmp_path), _meta(state),
                                        device="cpu")
    assert step == 7
    _same(restored, state)


def test_restore_checks_shapes_and_dtypes(tmp_path):
    save_checkpoint(str(tmp_path), _tree(), 1)
    wrong = _meta(_tree())
    wrong["nested"]["b"] = torch.empty((2, 2), dtype=torch.float32,
                                       device="meta")
    with pytest.raises(ValueError, match="nested"):
        restore_checkpoint(str(tmp_path), wrong, device="cpu")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), _meta(_tree()),
                           device="cpu")


def test_async_checkpointer_and_gc(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        ck.save(_tree(), s)
    ck.wait()
    ck.close()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]  # gc keeps last 2


def _twin():
    cfg = smoke_config("tinyllama-1.1b")
    mdl = build(cfg)
    ds = TokenStream(vocab_size=cfg.vocab_size, batch=2, seq_len=16, seed=0)
    return mdl, make_train_step(mdl), ds


def _run(step_fn, ds, n, state):
    for i in range(int(state["step"]), n):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}
        state, _ = step_fn(state, batch)
    return state


def test_checkpoint_restart_equivalence(tmp_path):
    """Fault-tolerance contract: train k steps, checkpoint, 'crash', restore,
    continue — must equal an uninterrupted run bit-for-bit."""
    mdl, step_fn, ds = _twin()
    full = _run(step_fn, ds, 6, init_train_state(mdl, device="cpu"))
    half = _run(step_fn, ds, 3, init_train_state(mdl, device="cpu"))
    save_checkpoint(str(tmp_path), half, 3)
    restored, _ = restore_checkpoint(str(tmp_path), train_state_specs(mdl),
                                     device="cpu")
    assert all(p.requires_grad for p in tree_leaves(restored["params"]))
    resumed = _run(step_fn, ds, 6, restored)
    assert int(resumed["step"]) == int(full["step"]) == 6
    _same(resumed, full)


def test_async_snapshot_survives_the_next_step(tmp_path, monkeypatch):
    """`save` copies the state before it returns: the train step updates
    params and moments in place, and a worker that wrote the live tensors
    would write the next step's state. The worker is held until that step
    has run."""
    mdl, step_fn, ds = _twin()
    state = _run(step_fn, ds, 1, init_train_state(mdl, device="cpu"))
    before = ckpt._unflatten(state, [t.detach().clone() for _, t in
                                     ckpt._flatten(state)])
    go = threading.Event()
    real = ckpt.save_checkpoint

    def held(directory, st, step):
        go.wait(60)
        return real(directory, st, step)

    monkeypatch.setattr(ckpt, "save_checkpoint", held)
    ck = AsyncCheckpointer(str(tmp_path), keep=3)
    ck.save(state, 1)
    state = _run(step_fn, ds, 2, state)
    assert not torch.equal(tree_leaves(state["params"])[0].detach(),
                           tree_leaves(before["params"])[0])
    go.set()
    ck.wait()
    ck.close()
    restored, step = restore_checkpoint(str(tmp_path),
                                        train_state_specs(mdl),
                                        device="cpu")
    assert step == 1
    _same(restored, before)


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------

def _ref_state(arch):
    jcfg = jax_smoke(arch)
    state = JS.init_train_state(jax_build(jcfg), 0)
    return jcfg, state, jax.tree_util.tree_map(np.asarray, state)


def _files(directory):
    return sorted(os.listdir(directory))


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_reference_checkpoint_restores_in_the_port(arch, tmp_path):
    _, state, state_np = _ref_state(arch)
    jax_ckpt.save_checkpoint(str(tmp_path), state, 5)
    cfg = smoke_config(arch)
    got, step = restore_checkpoint(str(tmp_path),
                                   train_state_specs(build(cfg)),
                                   device="cpu")
    assert step == 5
    want = train_state_from_reference(state_np, cfg, device="cpu")
    _same(got, want)
    assert all(p.requires_grad for p in tree_leaves(got["params"]))


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_port_checkpoint_is_the_references_bytes(arch, tmp_path):
    """For the same state the two packages write equal bytes, and the
    reference restores the port's checkpoint to its own state."""
    _, state, state_np = _ref_state(arch)
    port = train_state_from_reference(state_np, smoke_config(arch),
                                      device="cpu")
    ours, theirs = tmp_path / "port", tmp_path / "ref"
    save_checkpoint(str(ours), port, 9)
    jax_ckpt.save_checkpoint(str(theirs), state, 9)
    a, b = ours / "step_00000009", theirs / "step_00000009"
    assert _files(a) == _files(b)
    assert len(_files(a)) == len(jax.tree_util.tree_leaves(state)) + 1
    for name in _files(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
    restored, step = jax_ckpt.restore_checkpoint(str(ours), abstract)
    assert step == 9
    for x, y in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(state)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_paths_are_jax_keystr():
    """The port's leaf order and path strings are jax's
    (`tree_flatten_with_path`, `keystr`) on a nested dict with keys that
    sort differently from their insertion order."""
    tree = {"z": {"b": 1, "a": 2}, "a": {"y": {"x": 3}, "c": 4}, "m": 5}
    want = [(jax.tree_util.keystr(p), v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    port = {k: ({kk: (torch.tensor(vv) if not isinstance(vv, dict) else
                      {x: torch.tensor(y) for x, y in vv.items()})
                 for kk, vv in v.items()} if isinstance(v, dict)
                else torch.tensor(v)) for k, v in tree.items()}
    got = [(p, int(t)) for p, t in ckpt._flatten(port)]
    assert got == want


# ---------------------------------------------------------------------------
# Straggler logic (tests/test_distributed.py:35, :51)
# ---------------------------------------------------------------------------

def test_straggler_detection_and_reassignment():
    det = StragglerDetector(n_workers=4, threshold=1.5, patience=2)
    asg = ShardAssigner(n_shards=8, n_workers=4)
    flagged = []
    for _ in range(5):
        times = {0: 1.0, 1: 1.0, 2: 1.05, 3: 3.0}  # worker 3 is slow
        flagged = det.observe(times)
    assert flagged == [3]
    newmap = asg.reassign(flagged, det)
    assert 3 not in newmap and 3 in asg.evicted
    covered = sorted(s for shards in newmap.values() for s in shards)
    assert covered == list(range(8))        # every shard still owned
    assert asg.owner_of(3) != 3


def test_straggler_no_false_positive():
    det = StragglerDetector(n_workers=4, threshold=1.5, patience=3)
    for _ in range(10):
        assert det.observe({w: 1.0 + 0.05 * w for w in range(4)}) == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_equals_reference(seed):
    """Both packages' detectors and assigners on one seeded stream of step
    times, some workers slowed for a while: equal flags, EMAs, strikes,
    assignments and evictions at every observation."""
    rng = np.random.default_rng(seed)
    n = 6
    ours = StragglerDetector(n_workers=n, patience=2)
    theirs = jax_dist.StragglerDetector(n_workers=n, patience=2)
    a_ours = ShardAssigner(n_shards=12, n_workers=n)
    a_theirs = jax_dist.ShardAssigner(n_shards=12, n_workers=n)
    slow = rng.integers(0, n, 2)
    for i in range(30):
        times = {w: float(rng.uniform(0.9, 1.1)) for w in range(n)
                 if rng.random() < 0.9}
        if 10 <= i < 20:
            for w in slow:
                times[int(w)] = float(rng.uniform(2.0, 4.0))
        f_ours, f_theirs = ours.observe(times), theirs.observe(times)
        assert f_ours == f_theirs
        assert ours.ema == theirs.ema and ours.strikes == theirs.strikes
        assert (a_ours.reassign(f_ours, ours)
                == a_theirs.reassign(f_theirs, theirs))
        assert a_ours.evicted == a_theirs.evicted
