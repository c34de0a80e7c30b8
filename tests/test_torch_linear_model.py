"""The port's `core.linear_model` and `core.waters` against the JAX
package's: the numpy paths (`sgd_step`, `train_batch`,
`full_gradient_train`, `precision_recall`, `Waters`, `eps_bounds`) bit for
bit on the same seeded inputs, and `torch_sgd_step` against
`jax_sgd_step` to 1e-6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from repro.core import linear_model as RL                   # noqa: E402
from repro.core import waters as RW                         # noqa: E402

from repro_torch.core import linear_model as TL             # noqa: E402
from repro_torch.core import waters as TW                   # noqa: E402

METHODS = ["svm", "logistic", "ridge"]


def _data(n=200, d=12, seed=0):
    r = np.random.default_rng(seed)
    F = r.normal(size=(n, d)).astype(np.float32)
    Y = np.where(F @ r.normal(size=d) > 0, 1.0, -1.0)
    return F, Y


def _same(a, b):
    assert a.w.dtype == b.w.dtype == np.float32
    assert np.array_equal(a.w.view(np.uint32), b.w.view(np.uint32))
    assert type(a.b) is type(b.b) is float and a.b == b.b


@pytest.mark.parametrize("method", METHODS)
def test_sgd_step_bit_identical(method):
    F, Y = _data(seed=1)
    mt, mr = TL.zero_model(12), RL.zero_model(12)
    for f, y in zip(F, Y):
        mt = TL.sgd_step(mt, f, y, lr=0.05, l2=1e-3, method=method)
        mr = RL.sgd_step(mr, f, y, lr=0.05, l2=1e-3, method=method)
        _same(mt, mr)
    assert np.any(mt.w != 0)


@pytest.mark.parametrize("method", METHODS)
def test_batch_trainers_bit_identical(method):
    F, Y = _data(seed=2)
    _same(TL.train_batch(TL.zero_model(12), F, Y, lr=0.02, method=method,
                         epochs=2, seed=4),
          RL.train_batch(RL.zero_model(12), F, Y, lr=0.02, method=method,
                         epochs=2, seed=4))
    _same(TL.full_gradient_train(TL.zero_model(12), F, Y, lr=0.1,
                                 method=method, iters=50),
          RL.full_gradient_train(RL.zero_model(12), F, Y, lr=0.1,
                                 method=method, iters=50))
    with pytest.raises(ValueError):
        TL._loss_grad("hinge2", np.zeros(1), np.ones(1))


def test_model_helpers_equal():
    F, Y = _data(seed=3)
    mt = TL.train_batch(TL.zero_model(12), F, Y, lr=0.02)
    mr = RL.LinearModel(mt.w.copy(), mt.b)
    assert np.array_equal(mt.eps(F), mr.eps(F))
    assert np.array_equal(mt.predict(F), mr.predict(F))
    assert TL.precision_recall(mt, F, Y) == RL.precision_recall(mr, F, Y)
    c = mt.copy()
    c.w[0] += 1.0
    assert c.w[0] != mt.w[0]


@pytest.mark.parametrize("p", [1.0, 2.0, float("inf")])
def test_waters_bit_identical(p):
    F, Y = _data(seed=4)
    M = TW.holder_M(F, 2.0)
    wt, wr = TW.Waters(p=p, M=M), RW.Waters(p=p, M=M)
    stored_t, stored_r = TL.zero_model(12), RL.zero_model(12)
    mt, mr = TL.zero_model(12), RL.zero_model(12)
    for i, (f, y) in enumerate(zip(F[:60], Y[:60])):
        mt = TL.sgd_step(mt, f, y, lr=0.05)
        mr = RL.sgd_step(mr, f, y, lr=0.05)
        assert wt.update(mt, stored_t) == wr.update(mr, stored_r)
        assert TW.eps_bounds(mt, stored_t, M, p) == RW.eps_bounds(
            mr, stored_r, M, p)
        if i % 20 == 19:                        # a reorganize
            stored_t, stored_r = mt.copy(), mr.copy()
            wt.reset()
            wr.reset()
    assert (wt.lw, wt.hw) == (wr.lw, wr.hw) and wt.lw <= 0 <= wt.hw


@pytest.mark.parametrize("method", METHODS)
def test_torch_sgd_step_close_to_jax(method):
    F, Y = _data(n=50, seed=5)
    wt, bt = torch.zeros(12), torch.zeros(())
    wj, bj = jnp.zeros(12), jnp.float32(0.0)
    for f, y in zip(F, Y):
        wt, bt = TL.torch_sgd_step(wt, bt, torch.tensor(f), y, 0.05, 1e-3,
                                   method)
        wj, bj = RL.jax_sgd_step(wj, bj, jnp.asarray(f), y, 0.05, 1e-3,
                                 method)
    assert wt.dtype == torch.float32 and bt.shape == ()
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(bt), float(bj), rtol=1e-6, atol=1e-6)
    assert np.any(wt.numpy() != 0)
