"""The port's `ShardedFacade` (device="cpu") against the JAX package's,
driven with the same group commits as the SQL path drives them
(tests/test_sql.py:310-370: stacked SGD + one maintenance round per group
commit, hybrid point reads between commits), and a carry-over: the JAX
facade's state moved into the port mid-stream with `convert`.

The JAX driver passes `check_rep=False` to `shard_map`, which this host's
jax (0.9) no longer takes; the fixtures rename it to `check_vma` on
`repro.core.sharded.shard_map` for these tests only."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.sharded as ref_sharded                    # noqa: E402
from repro.core.facade import make_sharded_facade as ref_make  # noqa: E402
from repro.data import cora_like, multiclass_corpus         # noqa: E402

from repro_torch.core import convert                        # noqa: E402
from repro_torch.core.facade import make_sharded_facade     # noqa: E402

GROUP = 8


def shard_map_check_vma(mp):
    """Test-local shim: forward `check_rep` as `check_vma`."""
    orig = ref_sharded.shard_map

    def shim(*args, **kw):
        if "check_rep" in kw:
            kw["check_vma"] = kw.pop("check_rep")
        return orig(*args, **kw)

    mp.setattr(ref_sharded, "shard_map", shim)


def reference_snapshot(facade):
    """(state_np, host_np) of a reference `ShardedFacade`, the input
    `convert.from_reference` takes."""
    drv = facade.driver
    state_np = {f: np.asarray(getattr(facade.state, f))
                for f in convert.STATE_DTYPES}
    host_np = {
        "M": drv.M, "p": drv.p, "alpha": drv.alpha, "cap_frac": drv.cap_frac,
        "lw": drv.lw, "hw": drv.hw, "skiing_a": drv.skiing.a,
        "reorgs": drv.skiing.reorgs,
        "total_incremental": drv.skiing.total_incremental,
        "overflows": drv.overflows, "W": facade.W, "b": facade.b,
        "lr": facade.lr, "l2": facade.l2,
    }
    return state_np, host_np


def _commit(facades, rng, n, classes):
    rows = [int(rng.integers(0, n)) for _ in range(GROUP)]
    for fac in facades:
        fac.insert_examples(rows, [int(classes[i]) for i in rows])


def _assert_point_reads_equal(a, b, ids):
    for i in ids:
        la, ha = a.point_labels_of(i)
        lb, hb = b.point_labels_of(i)
        assert la.dtype == np.int8 and np.array_equal(la, lb), i
        assert ha == hb, i


def _assert_facades_equal(pt, jx):
    k = jx.num_views
    assert np.array_equal(pt.W, jx.W) and np.array_equal(pt.b, jx.b)
    assert np.array_equal(pt.counts(), jx.counts())
    for got, want in zip(pt.waters(), jx.waters()):
        assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    assert pt.driver.skiing.reorgs == jx.driver.skiing.reorgs
    assert pt.driver.overflows == jx.driver.overflows
    for v in range(k):
        for positive in (True, False):
            assert np.array_equal(pt.members(v, positive),
                                  jx.members(v, positive)), (v, positive)
        assert pt.band_info(v) == jx.band_info(v), v
        for desc in (True, False):
            pi, pz, pn = pt.top_margins(v, 7, desc)
            ji, jz, jn = jx.top_margins(v, 7, desc)
            assert np.array_equal(pi, ji) and pn == jn, (v, desc)
            np.testing.assert_allclose(pz, jz, rtol=1e-6, atol=1e-6)
    for i in range(0, pt.n, 17):
        assert pt.predict(i) == jx.predict(i), i
        assert np.array_equal(pt.labels_of(i), jx.labels_of(i)), i
        assert pt.margin(i, 1) == jx.margin(i, 1)
    assert pt.tier_hits == jx.tier_hits
    assert pt.disk_touches == jx.disk_touches


@pytest.fixture(scope="module")
def twin():
    with pytest.MonkeyPatch.context() as mp:
        shard_map_check_vma(mp)
        k, n, d = 4, 256, 16
        c = multiclass_corpus("eqs", n, d, k, seed=9)
        kw = dict(p=2.0, q=2.0, cap_frac=0.5)
        jx = ref_make(c.features, k, **kw)
        pt = make_sharded_facade(c.features, k, device="cpu", **kw)
        rng = np.random.default_rng(123)
        for _ in range(10):
            _commit([jx, pt], rng, n, c.classes)
            _assert_point_reads_equal(pt, jx, [int(rng.integers(0, n))])
        yield pt, jx


def test_point_labels_and_tiers_equal(twin):
    pt, jx = twin
    _assert_point_reads_equal(pt, jx, range(0, pt.n, 5))


def test_counts_members_margins_band_equal(twin):
    _assert_facades_equal(*twin)


def test_force_round_and_pending(twin):
    pt, jx = twin
    assert np.array_equal(pt.pending(), jx.pending())
    assert pt.policy == jx.policy == "eager"
    assert pt.telemetry_snapshot() == jx.telemetry_snapshot()


@pytest.fixture(scope="module")
def carried():
    """JAX facade 5 group commits on cora_like, state carried over into
    the port, then both continue 5 more."""
    with pytest.MonkeyPatch.context() as mp:
        shard_map_check_vma(mp)
        c = cora_like()
        jx = ref_make(c.features, c.num_classes, cap_frac=0.5)
        rng = np.random.default_rng(5)
        n = c.features.shape[0]
        for _ in range(5):
            _commit([jx], rng, n, c.classes)
        state_np, host_np = reference_snapshot(jx)
        pt = convert.from_reference(state_np, host_np, device="cpu")
        fresh = (pt.state.labels.clone(), pt.state.eps.clone())
        for _ in range(5):
            _commit([jx, pt], rng, n, c.classes)
        yield pt, jx, state_np, fresh


def test_carry_over_state_is_exact(carried):
    _, _, state_np, (labels, eps) = carried
    assert np.array_equal(labels.numpy(), state_np["labels"])
    assert np.array_equal(eps.numpy(), state_np["eps"])


def test_carry_over_continues_equal(carried):
    pt, jx, _, _ = carried
    _assert_point_reads_equal(pt, jx, range(0, pt.n, 13))
    _assert_facades_equal(pt, jx)
    assert pt.driver.skiing.total_incremental == \
        jx.driver.skiing.total_incremental
    assert np.array_equal(pt.F, jx.F)


def test_from_reference_rejects_broken_permutation(carried):
    _, _, state_np, _ = carried
    _, host_np = reference_snapshot(carried[1])
    bad = dict(state_np, gids=np.zeros_like(state_np["gids"]))
    with pytest.raises(ValueError, match="permutation"):
        convert.from_reference(bad, host_np, device="cpu")
