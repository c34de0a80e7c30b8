"""The port's optimizer, schedules and LM token stream (`optim/`,
`data/lm.py`) against the JAX package's: the analogues of
tests/test_checkpoint_optim_data.py's optimizer and data tests, then the
same seeded trees through both packages' `adamw_update`,
`clip_by_global_norm`, `global_norm` and `warmup_cosine` in f32 (within
1e-6) and bf16 leaves (the bf16 results equal as bf16 values or one bf16
ulp apart: the two packages may round an f32 value near a bf16 tie
differently), and `TokenStream.batch_at` equal array for array for several
(seed, step, shard)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro import optim as jopt                             # noqa: E402
from repro.data import TokenStream as JaxTokenStream        # noqa: E402

from repro_torch import optim                               # noqa: E402
from repro_torch.data import TokenStream                    # noqa: E402
from repro_torch.core.convert import _tensor                # noqa: E402

F32 = dict(rtol=1e-6, atol=1e-6)


def test_adamw_matches_reference():
    """The closed-form first step: m̂ = g, v̂ = g², so the step is sign(g)."""
    params = {"w": torch.tensor([1.0, -2.0])}
    grads = {"w": torch.tensor([0.5, 0.1])}
    opt = optim.adamw_init(params)
    new_p, opt = optim.adamw_update(params, grads, opt, lr=0.1, b1=0.9,
                                    b2=0.95, eps=1e-8, weight_decay=0.0)
    np.testing.assert_allclose(new_p["w"].numpy(), [0.9, -2.1], rtol=1e-5)
    assert int(opt["count"]) == 1 and opt["count"].dtype == torch.int32
    assert opt["m"]["w"].dtype == torch.float32


def test_clip_and_schedule():
    g = {"a": torch.full((3,), 10.0)}
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(300.0))
    assert float(clipped["a"].norm()) == pytest.approx(1.0, rel=1e-4)
    assert float(optim.warmup_cosine(torch.tensor(0), peak_lr=1.0,
                                     warmup_steps=10, total_steps=100)) \
        == pytest.approx(0.1)
    assert float(optim.warmup_cosine(torch.tensor(100), peak_lr=1.0,
                                     warmup_steps=10, total_steps=100)) \
        == pytest.approx(0.1, rel=1e-2)


def test_tokenstream_determinism_and_sharding():
    a = TokenStream(vocab_size=100, batch=4, seq_len=8, seed=1, shard=0,
                    num_shards=2)
    b = TokenStream(vocab_size=100, batch=4, seq_len=8, seed=1, shard=0,
                    num_shards=2)
    np.testing.assert_array_equal(a.batch_at(5)["tokens"],
                                  b.batch_at(5)["tokens"])
    c = TokenStream(vocab_size=100, batch=4, seq_len=8, seed=1, shard=1,
                    num_shards=2)
    assert not np.array_equal(a.batch_at(5)["tokens"],
                              c.batch_at(5)["tokens"])
    got = a.batch_at(3)
    assert got["tokens"].shape == (4, 8) and got["targets"].shape == (4, 8)
    np.testing.assert_array_equal(got["tokens"][:, 1:],
                                  got["targets"][:, :-1])


@pytest.mark.parametrize("seed,step,shard,num_shards", [
    (0, 0, 0, 1), (0, 7, 0, 1), (3, 2, 1, 4), (11, 100, 3, 4)])
def test_tokenstream_equals_reference(seed, step, shard, num_shards):
    kw = dict(vocab_size=512, batch=3, seq_len=40, seed=seed, shard=shard,
              num_shards=num_shards)
    want = JaxTokenStream(**kw).batch_at(step)
    got = TokenStream(**kw).batch_at(step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def _trees(dtype, seed):
    """(params, grads, opt state) as seeded numpy trees: leaves of several
    shapes, a gradient with a large norm (so clipping binds), moments
    after some steps, count 3."""
    r = np.random.default_rng(seed)
    shapes = {"w": (5, 7), "blocks": {"a": (3, 4, 2), "b": (6,)},
              "scale": (7,)}

    def tree(fn):
        return {k: (tree_of(v, fn)) for k, v in shapes.items()}

    def tree_of(v, fn):
        if isinstance(v, dict):
            return {k: fn(s) for k, s in v.items()}
        return fn(v)

    params = tree(lambda s: r.normal(size=s).astype(np.float32))
    grads = tree(lambda s: (3 * r.normal(size=s)).astype(np.float32))
    m = tree(lambda s: (0.1 * r.normal(size=s)).astype(np.float32))
    v = tree(lambda s: (0.01 * r.random(s)).astype(np.float32))
    if dtype == "bfloat16":
        cast = lambda t: jax.tree_util.tree_map(           # noqa: E731
            lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), t)
        params, grads = cast(params), cast(grads)
    return params, grads, {"m": m, "v": v, "count": np.int32(3)}


def _to_torch(tree):
    return jax.tree_util.tree_map(_tensor, tree)


def _close(got, want, dtype):
    """Leaf by leaf: f32 within 1e-6; bf16 equal or one bf16 ulp apart."""
    flat = jax.tree_util.tree_leaves(want)
    for g, w in zip(optim.tree_leaves(got), flat):
        w = np.asarray(w)
        assert g.dtype == {"float32": torch.float32,
                           "bfloat16": torch.bfloat16}[w.dtype.name]
        if w.dtype.name == "bfloat16":
            ulp = np.abs(np.asarray(w, np.float32)) * 2.0 ** -7 + 1e-30
            diff = np.abs(g.float().numpy() - np.asarray(w, np.float32))
            assert (diff <= ulp).all(), float(diff.max())
        else:
            np.testing.assert_allclose(g.numpy(), w, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_update_equals_reference(dtype, weight_decay):
    params, grads, opt = _trees(dtype, 1)
    lr = np.float32(3e-3)
    want_p, want_o = jopt.adamw_update(params, grads, opt, jnp.asarray(lr),
                                       weight_decay=weight_decay)
    got_p, got_o = optim.adamw_update(_to_torch(params), _to_torch(grads),
                                      _to_torch(opt), torch.tensor(lr),
                                      weight_decay=weight_decay)
    _close(got_p, want_p, dtype)
    _close(got_o["m"], want_o["m"], "float32")
    _close(got_o["v"], want_o["v"], "float32")
    assert int(got_o["count"]) == int(want_o["count"]) == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_updates_in_place(dtype):
    """The port's AdamW overwrites the given tensors (the training step's
    state: no second copy) and returns the given trees."""
    params, grads, opt = _trees(dtype, 2)
    p, o = _to_torch(params), _to_torch(opt)
    leaves = optim.tree_leaves(p) + optim.tree_leaves(o)
    got_p, got_o = optim.adamw_update(p, _to_torch(grads), o, 1e-2,
                                      weight_decay=0.1)
    assert got_p is p and got_o is o
    assert all(a is b for a, b in zip(optim.tree_leaves(p)
                                      + optim.tree_leaves(o), leaves))
    assert int(o["count"]) == 4
    assert not torch.equal(optim.tree_leaves(p)[0],
                           _to_torch(params)["blocks"]["a"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_equals_reference(dtype, max_norm):
    """Clipping binds at 1.0 and not at 1e3; bf16 gradients are scaled by
    the factor rounded to bf16, as the reference casts it."""
    _, grads, _ = _trees(dtype, 3)
    want, want_n = jopt.clip_by_global_norm(grads, max_norm)
    got, got_n = optim.clip_by_global_norm(_to_torch(grads), max_norm)
    np.testing.assert_allclose(float(got_n), float(want_n), **F32)
    np.testing.assert_allclose(float(optim.global_norm(_to_torch(grads))),
                               float(jopt.global_norm(grads)), **F32)
    _close(got, want, dtype)


@pytest.mark.parametrize("step", [0, 1, 49, 99, 100, 101, 5000, 9999, 10000,
                                  20000])
def test_warmup_cosine_equals_reference(step):
    kw = dict(peak_lr=3e-4, warmup_steps=100, total_steps=10_000)
    want = jopt.warmup_cosine(jnp.asarray(step, jnp.int32), **kw)
    got = optim.warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), **F32)
    assert float(optim.constant(torch.tensor(step), peak_lr=0.5)) == 0.5


def test_sgd_update_equals_reference():
    params, grads, _ = _trees("float32", 4)
    mom = jax.tree_util.tree_map(np.zeros_like, params)
    for momentum in (0.0, 0.9):
        want_p, want_m = jopt.sgd_update(params, grads, 0.1, mom, momentum)
        got_p, got_m = optim.sgd_update(_to_torch(params), _to_torch(grads),
                                        0.1, _to_torch(mom), momentum)
        _close(got_p, want_p, "float32")
        _close(got_m, want_m, "float32")
