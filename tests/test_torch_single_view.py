"""The port's single-view `ShardedHazy(device="cpu")` against the JAX
package's `ShardedHazy` on a (1, 1) ("data", "model") host mesh, over the
stream of tests/test_distributed.py::test_sharded_hazy_multidevice_consistency:
forest_like(scale=0.01) (5,820 x 54), M = 1, p = 2, cap_frac = 1/4, 400
SGD updates from example_stream(seed=3, label_noise=0.0).

Labels in entity order must be exact; all_members, reorgs and overflows
equal; the waters bit for bit; eps to 1e-6. The reference's single-view
steps pass no `check_rep`, so they build on this host's jax without a
shim. The reference driver does not count overflows; the fixture reads
them off its banded step's `wmax`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

import repro.core.sharded as ref_sharded                    # noqa: E402
from repro.core import sgd_step as ref_sgd, zero_model as ref_zero  # noqa: E402
from repro.data import forest_like as ref_forest            # noqa: E402
from repro.launch.mesh import make_host_mesh                # noqa: E402

from repro_torch.core import sgd_step, zero_model           # noqa: E402
from repro_torch.core.convert import single_view_from_reference  # noqa: E402
from repro_torch.core.sharded import (ShardedHazy, all_members,  # noqa: E402
                                      naive_update)
from repro_torch.data import example_stream, forest_like    # noqa: E402
from repro_torch.kernels.band_reclassify import kernel as band_kernel  # noqa: E402
from repro_torch.kernels.eps_affine import kernel as eps_kernel  # noqa: E402

UPDATES, SEED, CAP_FRAC = 400, 3, 1 / 4


class RefRun:
    """The reference driver with its overflows counted."""

    def __init__(self, F):
        n, d = F.shape
        self.mesh = make_host_mesh((1, 1))
        self.sh = ref_sharded.ShardedHazy(mesh=self.mesh, n=n, d=d, M=1.0,
                                          p=2.0, cap_frac=CAP_FRAC)
        self.overflows = 0
        hazy = self.sh._hazy

        def counted(state, w, b):
            state, wsum, wmax = hazy(state, w, b)
            self.overflows += int(wmax) > self.sh.cap
            return state, wsum, wmax

        self.sh._hazy = counted

    def apply(self, state, model):
        return self.sh.apply_model(state, jnp.asarray(model.w),
                                   jnp.asarray(model.b, jnp.float32))


def _entity_order(labels, perm):
    out = np.empty_like(labels)
    out[perm] = labels
    return out


def _models(corpus, count):
    """The host model after each example: the port's and the reference's
    sgd_step side by side (they must agree bit for bit)."""
    port, ref = zero_model(corpus.features.shape[1]), ref_zero(
        corpus.features.shape[1])
    stream = example_stream(corpus, seed=SEED, label_noise=0.0)
    out = []
    for _, f, y in (next(stream) for _ in range(count)):
        port = sgd_step(port, f, y, lr=0.02, l2=1e-3)
        ref = ref_sgd(ref, f, y, lr=0.02, l2=1e-3)
        assert np.array_equal(port.w, ref.w) and port.b == ref.b
        out.append(port)
    return out


FIELDS = ("F", "eps", "labels", "perm", "w_stored", "b_stored", "lw", "hw")
CARRY_AT = 200


def _snapshot(jx, js):
    """A reference state and its driver's host state, as numpy and plain
    values (what `convert.single_view_from_reference` takes)."""
    sh = jx.sh
    return ({f: np.asarray(getattr(js, f)) for f in FIELDS},
            dict(lw=sh.lw, hw=sh.hw, skiing_a=sh.skiing.a,
                 reorgs=sh.skiing.reorgs,
                 total_incremental=sh.skiing.total_incremental, M=sh.M,
                 p=sh.p, alpha=sh.alpha, cap_frac=sh.cap_frac,
                 overflows=jx.overflows))


@pytest.fixture(scope="module")
def run():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # tiny CPU products: threads only cost
    try:
        c = forest_like(scale=0.01)
        F = np.ascontiguousarray(c.features)
        assert np.array_equal(F, ref_forest(scale=0.01).features)
        n, d = F.shape
        models = _models(c, UPDATES)
        jx = RefRun(F)
        pt = ShardedHazy(n=n, d=d, M=1.0, p=2.0, cap_frac=CAP_FRAC,
                         device="cpu")
        js, ps = jx.sh.init_state(F), pt.init_state(F)
        init_identity = np.array_equal(ps.perm.numpy(), np.arange(n))
        launches0 = (band_kernel.band_reclassify.launches,
                     eps_kernel.eps_affine.launches)
        for i, m in enumerate(models):
            if i == CARRY_AT:
                carry = _snapshot(jx, js)
            js = jx.apply(js, m)
            ps = pt.apply_model(ps, m.w, m.b)
        yield dict(F=F, n=n, c=c, model=models[-1], models=models, jx=jx,
                   pt=pt, js=js, ps=ps, init_identity=init_identity,
                   carry=carry,
                   launches=(band_kernel.band_reclassify.launches
                             - launches0[0],
                             eps_kernel.eps_affine.launches - launches0[1]))
    finally:
        torch.set_num_threads(threads)


def test_labels_in_entity_order_equal(run):
    js, ps, m = run["js"], run["ps"], run["model"]
    jlab = _entity_order(np.asarray(js.labels), np.asarray(js.perm))
    plab = run["pt"].labels_in_entity_order(ps)
    assert ps.labels.dtype == torch.int8 and ps.perm.dtype == torch.int32
    assert np.array_equal(plab, jlab)
    truth = np.where(run["F"] @ m.w - m.b >= 0, 1, -1)
    assert np.array_equal(plab, truth)
    assert run["init_identity"]     # z ≡ 0 under the zero model


def test_all_members_equal(run):
    got = run["pt"].all_members(run["ps"])
    assert got == run["jx"].sh.all_members(run["js"])
    assert got == int((run["pt"].labels_in_entity_order(run["ps"]) == 1).sum())
    assert 0 < got < run["n"]
    assert all_members(run["ps"]).dtype == torch.int32


def test_reorgs_and_overflows_equal(run):
    jx, pt = run["jx"], run["pt"]
    assert pt.cap == jx.sh.cap == 1455
    assert pt.skiing.reorgs == jx.sh.skiing.reorgs == 53
    assert pt.overflows == jx.overflows >= 1
    assert pt.skiing.a == jx.sh.skiing.a
    assert pt.skiing.total_incremental == jx.sh.skiing.total_incremental > 0
    # on the CPU the plain versions run: no CUDA kernel launched
    assert run["launches"] == (0, 0)


def test_waters_and_stored_model_bit_identical(run):
    jx, pt, js, ps = run["jx"], run["pt"], run["js"], run["ps"]
    assert isinstance(pt.lw, float) and isinstance(pt.hw, float)
    assert np.float64(pt.lw).view(np.uint64) == np.float64(
        jx.sh.lw).view(np.uint64)
    assert np.float64(pt.hw).view(np.uint64) == np.float64(
        jx.sh.hw).view(np.uint64)
    assert pt.lw < 0 < pt.hw
    assert ps.b_stored.dtype == torch.float32
    assert np.array_equal(ps.b_stored.numpy(), np.asarray(js.b_stored))
    assert np.array_equal(ps.w_stored.numpy(), np.asarray(js.w_stored))


def test_eps_in_entity_order_close(run):
    js, ps = run["js"], run["ps"]
    jeps = _entity_order(np.asarray(js.eps), np.asarray(js.perm))
    peps = _entity_order(ps.eps.numpy(), ps.perm.numpy())
    np.testing.assert_allclose(peps, jeps, rtol=1e-6, atol=1e-6)
    assert np.all(np.diff(ps.eps.numpy()) >= 0)        # eps-sorted rows


def test_naive_step_equals_reference(run):
    """`naive_update` against `make_naive_update_step`: labels exact under
    a model the stored state has not seen; nothing but labels changes."""
    js, ps = run["js"], run["ps"]
    m = run["models"][len(run["models"]) // 2]
    naive = ref_sharded.make_naive_update_step(run["jx"].mesh)
    jn = naive(js, jnp.asarray(m.w), jnp.asarray(m.b, jnp.float32))
    pn = naive_update(ps, torch.tensor(m.w), torch.tensor(np.float32(m.b)))
    jlab = _entity_order(np.asarray(jn.labels), np.asarray(jn.perm))
    plab = _entity_order(pn.labels.numpy(), pn.perm.numpy())
    assert np.array_equal(plab, jlab)
    assert np.array_equal(plab, np.where(run["F"] @ m.w - m.b >= 0, 1, -1))
    assert not np.array_equal(plab, run["pt"].labels_in_entity_order(ps))
    for field in ("F", "eps", "perm", "w_stored", "b_stored", "lw", "hw"):
        assert getattr(pn, field) is getattr(ps, field), field
    # the driver's naive round is the same step
    pd = run["pt"].apply_model_naive(ps, m.w, m.b)
    assert np.array_equal(pd.labels.numpy(), pn.labels.numpy())


def test_carry_over_mid_stream(run):
    """The reference driver carried into the port after 200 updates: the
    port continues over the next 200 to the reference's labels, counts,
    schedules and waters."""
    jx, js = run["jx"], run["js"]
    state_np, host_np = run["carry"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pt, ps = single_view_from_reference(state_np, host_np, device="cpu")
        assert pt.cap == jx.sh.cap and pt.overflows == host_np["overflows"]
        assert pt.skiing.reorgs == host_np["reorgs"] > 0
        for m in run["models"][CARRY_AT:]:
            ps = pt.apply_model(ps, m.w, m.b)
    finally:
        torch.set_num_threads(threads)
    assert np.array_equal(
        pt.labels_in_entity_order(ps),
        _entity_order(np.asarray(js.labels), np.asarray(js.perm)))
    assert pt.all_members(ps) == jx.sh.all_members(js)
    assert pt.skiing.reorgs == jx.sh.skiing.reorgs
    assert pt.overflows == jx.overflows
    assert (pt.lw, pt.hw) == (jx.sh.lw, jx.sh.hw)
    bad = {f: np.zeros_like(v) for f, v in state_np.items()}
    with pytest.raises(ValueError, match="permutation"):
        single_view_from_reference(bad, host_np, device="cpu")
