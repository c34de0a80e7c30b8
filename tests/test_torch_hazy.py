"""The port's host engine shells `HazyEngine` and `NaiveEngine`
(`repro_torch.core.hazy`, device="cpu", the kernels' plain versions)
against the reference's (`repro.core.hazy`), over one seeded stream:
forest_like(scale=0.01) (5,820 x 54), p = q = 2, 400 SGD updates of
example_stream(seed=3) (lr 0.02, l2 1e-3), in cost_mode="modeled"; also
the exact-water-boundary case of tests/test_hybrid.py, the SKIING
schedule and offline optimum, and a carry-over mid-stream through
`convert.hazy_from_reference`.

What must hold (ROADMAP's standard):
  * labels in entity order exact, but for a proven fp32 tie:
    |w·f − b| ≤ 1e-6·(‖f‖‖w‖ + |b|) in float64 (tests/test_kernels.py);
  * counts, members, reorg counts, the SKIING accumulator, rounds and
    `tuples_reclassified` exact;
  * waters and stored models bit for bit, every round;
  * eps (entity order) within the fp32 rounding bound of the dot:
    |got − want| ≤ 2·(d + 1)·2⁻²⁴·(Σ_i |f_i·w_i| + |b|)
    (tests/test_torch_eps_affine.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import hazy as R                            # noqa: E402
from repro.core import skiing as RS                         # noqa: E402
from repro.core.linear_model import LinearModel as RModel   # noqa: E402
from repro.core.linear_model import sgd_step, zero_model    # noqa: E402
from repro.data import example_stream, forest_like          # noqa: E402

from repro_torch.core import hazy as T                      # noqa: E402
from repro_torch.core import skiing as TS                   # noqa: E402
from repro_torch.core.convert import hazy_from_reference    # noqa: E402
from repro_torch.core.linear_model import LinearModel       # noqa: E402

UPDATES, SEED, CHECK_EVERY = 400, 3, 50
TIE_RTOL = 1e-6
POLICIES = {"eager": {}, "lazy": {}, "hybrid": dict(buffer_frac=0.01)}


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny CPU products: torch's threads only cost here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream():
    """forest_like(0.01) and the model after each of UPDATES examples."""
    c = forest_like(scale=0.01)
    it = example_stream(c, seed=SEED)
    model = zero_model(c.features.shape[1])
    models = []
    for _, f, y in (next(it) for _ in range(UPDATES)):
        model = sgd_step(model, f, y, lr=0.02, l2=1e-3)
        models.append(model)
    return np.ascontiguousarray(c.features, np.float32), models


def tie_mismatches(got, want, F, w, b):
    """Entity-order label arrays: the number of disagreements that are NOT
    proven fp32 ties of sign(F·w − b)."""
    bad = np.flatnonzero(got != want)
    f = F[bad].astype(np.float64)
    z = f @ np.asarray(w, np.float64) - float(b)
    tol = TIE_RTOL * (np.linalg.norm(f, axis=1)
                      * np.linalg.norm(np.asarray(w, np.float64)) + abs(b))
    return int((np.abs(z) > tol).sum())


def eps_within_bound(got, want, F, w, b):
    mass = np.abs(F.astype(np.float64) * np.asarray(w, np.float64)).sum(1)
    bound = 2 * (F.shape[1] + 1) * 2.0 ** -24 * (mass + abs(float(b)))
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (diff <= bound).all(), float((diff / bound).max())


def entity_order(ref, port):
    """(ref labels, port labels, ref eps, port eps) indexed by entity."""
    rl = np.empty(ref.n, np.int8)
    rl[ref.perm] = ref.labels_sorted
    pl = np.empty(ref.n, np.int8)
    pl[port.perm.numpy()] = port.labels_sorted.numpy()
    return (rl, pl, ref.eps_sorted[ref.inv_perm],
            port.eps_sorted[port.inv_perm].numpy())


def assert_same_state(ref, port, F):
    """Waters and stored model bit for bit; the counts, labels and eps as
    the module docstring states (lazy views are caught up first)."""
    assert (port.waters.lw, port.waters.hw) == (ref.waters.lw, ref.waters.hw)
    assert np.array_equal(port.stored.w, ref.stored.w)
    assert port.stored.b == ref.stored.b
    m, s = ref.model, ref.stored
    members, got = ref.all_members(), port.all_members()   # catch up
    rl, pl, re, pe = entity_order(ref, port)
    ties = int((rl != pl).sum())
    assert tie_mismatches(pl, rl, F, m.w, m.b) == 0
    assert abs(got - members) <= ties
    # numpy 2 keeps F @ w − b in f32 (b is a Python float); so does the port
    assert re.dtype == np.float32 and pe.dtype == np.float32
    eps_within_bound(pe, re, F, s.w, s.b)


def _pair(F, policy, **kw):
    opts = dict(p=2.0, q=2.0, policy=policy, cost_mode="modeled",
                **POLICIES[policy], **kw)
    return R.HazyEngine(F, **opts), T.HazyEngine(F, device="cpu", **opts)


def _run(ref, port, F, models):
    for j, m in enumerate(models):
        ref.apply_model(m)
        port.apply_model(m)
        assert (port.waters.lw, port.waters.hw) == (ref.waters.lw,
                                                    ref.waters.hw), j
        if j % CHECK_EVERY == CHECK_EVERY - 1:
            for i in range(0, ref.n, 53):
                if ref.policy == "hybrid":
                    assert port.hybrid_label(i) == ref.hybrid_label(i), (j, i)
                assert port.label(i) == ref.label(i), (j, i)
            assert_same_state(ref, port, F)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_hazy_engine_matches_reference(stream, policy):
    F, models = stream
    ref, port = _pair(F, policy)
    _run(ref, port, F, models)
    assert_same_state(ref, port, F)
    assert port.skiing.reorgs == ref.skiing.reorgs > 0
    assert port.skiing.a == ref.skiing.a
    assert port.stats.rounds == ref.stats.rounds == UPDATES
    assert port.stats.reorgs == ref.stats.reorgs
    assert port.stats.tuples_reclassified == ref.stats.tuples_reclassified
    assert port.stats.tuples_total_possible == ref.stats.tuples_total_possible
    assert np.array_equal(np.sort(port.members()), np.sort(ref.members()))
    assert port.band_fraction() == ref.band_fraction()
    assert port.disk_touches == ref.disk_touches
    assert port.check_consistent() and ref.check_consistent()


@pytest.mark.parametrize("policy", ["eager", "lazy"])
def test_naive_engine_matches_reference(stream, policy):
    F, models = stream
    ref = R.NaiveEngine(F, policy=policy)
    port = T.NaiveEngine(F, policy=policy, device="cpu")
    for m in models[:150]:
        ref.apply_model(m)
        port.apply_model(m)
    m = models[149]
    members = ref.all_members()
    got = port.all_members()
    ties = int((port.labels.numpy() != ref.labels).sum())
    assert tie_mismatches(port.labels.numpy(), ref.labels, F, m.w, m.b) == 0
    assert abs(got - members) <= ties
    for i in range(0, ref.n, 29):
        assert port.label(i) == ref.label(i)


def test_measured_mode_stays_exact(stream):
    """Wall-time SKIING (the paper's choice): the schedule follows this
    host's clock, so only the golden invariant is compared."""
    F, models = stream
    port = T.HazyEngine(F, p=2.0, q=2.0, device="cpu")
    assert port.cost_mode == "measured" and port.skiing.S > 0
    for m in models[:200]:
        port.apply_model(m)
    assert port.check_consistent()
    assert port.cost.snapshot(0)["steps_measured"] > 0


def test_exact_water_boundary_single_view():
    """tests/test_hybrid.py's exact-water-mark case on both packages: an
    entity AT hw is short-circuited positive, one AT lw is reclassified
    (z == 0 labels +1), and the probe agrees with the band search."""
    F = np.array([[2.0], [1.0], [0.5], [-1.0], [-2.0]], np.float32)
    out = {}
    for name, mod, Model, kw in (("ref", R, RModel, {}),
                                 ("port", T, LinearModel,
                                  dict(device="cpu"))):
        eng = mod.HazyEngine(F, p=2.0, q=2.0, policy="eager", **kw)
        eng.model = Model(np.array([1.0], np.float32), 0.0)
        eng.reorganize()
        eng.apply_model(Model(np.array([1.0], np.float32), 1.0))
        assert (eng.waters.lw, eng.waters.hw) == (0.0, 1.0)
        up = [eng.hybrid_label(i) for i in range(5)]
        assert up[1] == (1, "water")
        assert [eng.label(i) for i in range(5)] == [t for t, _ in up]
        assert eng.check_consistent()
        eng2 = mod.HazyEngine(F, p=2.0, q=2.0, policy="eager", **kw)
        eng2.model = Model(np.array([1.0], np.float32), 0.0)
        eng2.reorganize()
        eng2.apply_model(Model(np.array([1.0], np.float32), -1.0))
        assert (eng2.waters.lw, eng2.waters.hw) == (-1.0, 0.0)
        down = [eng2.hybrid_label(i) for i in range(5)]
        assert down[3][0] == 1 and down[3][1] != "water"
        assert down[4] == (-1, "water")
        assert eng2.label(3) == 1 and eng2.check_consistent()
        out[name] = (up, down, eng.all_members(), eng2.all_members())
    assert out["port"] == out["ref"]


COSTS = [lambda s, i: 0.1 * (i - s),
         lambda s, i: 0.05 * (i - s) ** 1.5,
         lambda s, i: 1.0 if (i - s) % 7 == 0 else 0.02]


@pytest.mark.parametrize("cost", COSTS, ids=["linear", "convex", "spiky"])
@pytest.mark.parametrize("alpha", [1.0, RS.alpha_star(0.3)])
def test_skiing_schedule_and_opt_cost_match(cost, alpha):
    for n, S in ((12, 0.7), (40, 1.0)):
        assert TS.skiing_schedule(cost, n, S, alpha) == \
            RS.skiing_schedule(cost, n, S, alpha)
        assert TS.opt_cost(cost, n, S) == RS.opt_cost(cost, n, S)
        _, total = TS.skiing_schedule(cost, n, S, alpha)
        assert total <= (1 + alpha + 1.0) * TS.opt_cost(cost, n, S) + 2 * S


@pytest.mark.parametrize("policy", list(POLICIES))
def test_carry_over_mid_stream(stream, policy):
    """The reference engine after half the stream, carried across: both
    continue over the second half and stay identical."""
    F, models = stream
    half = UPDATES // 2
    ref = R.HazyEngine(F, p=2.0, q=2.0, policy=policy, cost_mode="modeled",
                       **POLICIES[policy])
    for m in models[:half]:
        ref.apply_model(m)
    port = hazy_from_reference(ref, device="cpu")
    assert torch.equal(port.perm, torch.as_tensor(ref.perm))
    assert np.array_equal(port.eps_sorted.numpy(), ref.eps_sorted)
    assert port.pos_count == ref.pos_count
    assert (port._pending is None) == (ref._pending is None)
    reorgs = ref.skiing.reorgs
    _run(ref, port, F, models[half:])
    assert_same_state(ref, port, F)
    assert port.skiing.reorgs == ref.skiing.reorgs > reorgs
    assert port.stats.tuples_reclassified == ref.stats.tuples_reclassified
    assert port.check_consistent()


def test_storage_tier_waits():
    """The storage tier is in: `store=` attaches a `BufferPool`, which
    the engine's first reorganize warms (a full budget takes every page,
    as prefetches, not misses)."""
    from repro_torch.storage import BufferPool, EntityStore
    F = np.random.default_rng(0).normal(size=(8, 2)).astype(np.float32)
    pool = BufferPool(EntityStore.from_array(F, page_bytes=16), F.nbytes)
    eng = T.HazyEngine(F, store=pool, device="cpu")
    assert eng.store is pool and pool.misses == 0
    assert pool.prefetches == pool.store.num_pages == 4
    pool.store.close()
