"""The port's `MultiViewEngine` (`repro_torch.core.multiview`,
device="cpu") against the reference's (`repro.core.multiview`) over one
seeded stream: cora_like() (k = 7 one-vs-all views), p = q = 2, 480
stacked SGD examples of multiclass_example_stream(seed=11) applied in
rounds of 4, cost_mode="modeled", under the eager, lazy and hybrid
(buffer_frac 0.02) policies; also the multi-view exact-water-boundary
case and per-view pending isolation of tests/test_hybrid.py, and a
carry-over mid-stream through `convert.multiview_from_reference`.

What must hold (ROADMAP's standard):
  * labels in entity order exact, but for a proven fp32 tie:
    |w·f − b| ≤ 1e-6·(‖f‖‖w‖ + |b|) in float64 (tests/test_kernels.py);
  * per-view counts, members, reorg counts, SKIING accumulators, pending
    masks, lazy waste, probe answers and tiers, `tuples_reclassified`
    exact;
  * waters and stored models bit for bit, every round;
  * eps (entity order) within the fp32 rounding bound of the dot:
    |got − want| ≤ 2·(d + 1)·2⁻²⁴·(Σ_i |f_i·w_i| + |b|)
    (tests/test_torch_eps_affine.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import multiview as R                       # noqa: E402
from repro.core.multiclass import sgd_all_views             # noqa: E402
from repro.data import cora_like, multiclass_example_stream  # noqa: E402

from repro_torch.core import multiview as T                 # noqa: E402
from repro_torch.core.convert import multiview_from_reference  # noqa: E402

EXAMPLES, GROUP, SEED = 480, 4, 11
TIE_RTOL = 1e-6
POLICIES = {"eager": {}, "lazy": {}, "hybrid": dict(buffer_frac=0.02)}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream():
    """cora_like() and the stacked models after each round of GROUP."""
    c = cora_like()
    k = c.num_classes
    F = np.ascontiguousarray(c.features, np.float32)
    W, b = np.zeros((k, F.shape[1]), np.float32), np.zeros(k)
    it = multiclass_example_stream(c, seed=SEED)
    rounds = []
    for j in range(EXAMPLES):
        i, cls = next(it)
        W, b = sgd_all_views(W, b, F[i], cls, lr=0.1, l2=1e-4)
        if j % GROUP == GROUP - 1:
            rounds.append((W.copy(), b.copy()))
    return F, k, rounds


def tie_mismatches(got, want, F, W, b):
    """(k, n) entity-order labels: disagreements that are NOT proven fp32
    ties of sign(F·W[v] − b[v])."""
    v, r = np.nonzero(got != want)
    f = F[r].astype(np.float64)
    w = W[v].astype(np.float64)
    z = (f * w).sum(1) - b[v]
    tol = TIE_RTOL * (np.linalg.norm(f, axis=1) * np.linalg.norm(w, axis=1)
                      + np.abs(b[v]))
    return int((np.abs(z) > tol).sum())


def entity_order(ref, port):
    rl = np.take_along_axis(ref.labels_sorted, ref.inv_perm, 1)
    pl = torch.gather(port.labels_sorted, 1, port.inv_perm).numpy()
    re = np.take_along_axis(ref.eps_sorted, ref.inv_perm, 1)
    pe = torch.gather(port.eps_sorted, 1, port.inv_perm).numpy()
    return rl, pl, re, pe


def assert_same_state(ref, port, F):
    for name in ("lw", "hw", "W_stored", "b_stored", "pending",
                 "_waters_stale", "acc", "S", "reorg_counts", "lazy_waste",
                 "hybrid_hits", "buffer_lo", "buffer_hi"):
        assert np.array_equal(getattr(port, name), getattr(ref, name)), name
    counts, got = ref.all_members(), port.all_members()      # catch up
    rl, pl, re, pe = entity_order(ref, port)
    ties = int((rl != pl).sum())
    assert tie_mismatches(pl, rl, F, ref.W, ref.b) == 0
    assert np.abs(got - counts).sum() <= ties
    assert re.dtype == np.float32 and pe.dtype == np.float32
    mass = np.abs(F.astype(np.float64)[None] * ref.W_stored.astype(
        np.float64)[:, None]).sum(2)
    bound = 2 * (F.shape[1] + 1) * 2.0 ** -24 * (
        mass + np.abs(ref.b_stored)[:, None])
    diff = np.abs(pe.astype(np.float64) - re)
    assert (diff <= bound).all(), float((diff / bound).max())


def _run(ref, port, F, rounds, probe_every=10):
    k = ref.k
    for j, (W, b) in enumerate(rounds):
        ref.apply_models(W, b)
        port.apply_models(W, b)
        assert np.array_equal(port.lw, ref.lw) and \
            np.array_equal(port.hw, ref.hw), j
        if j % probe_every == probe_every - 1:
            for i in range(0, ref.n, 89):
                if ref.policy == "hybrid":
                    a, p = ref.hybrid_labels_of(i), port.hybrid_labels_of(i)
                    assert np.array_equal(p[0], a[0]) and \
                        np.array_equal(p[1], a[1]), (j, i)
                    assert port.hybrid_label(j % k, i) == \
                        ref.hybrid_label(j % k, i)
                assert port.label(j % k, i) == ref.label(j % k, i), (j, i)
            assert_same_state(ref, port, F)


def _pair(F, k, policy):
    opts = dict(p=2.0, q=2.0, policy=policy, cost_mode="modeled",
                **POLICIES[policy])
    return R.MultiViewEngine(F, k, **opts), T.MultiViewEngine(
        F, k, device="cpu", **opts)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_multiview_engine_matches_reference(stream, policy):
    F, k, rounds = stream
    ref, port = _pair(F, k, policy)
    _run(ref, port, F, rounds)
    assert_same_state(ref, port, F)
    assert ref.reorg_counts.sum() > 0
    assert port.stats.rounds == ref.stats.rounds == len(rounds)
    assert port.stats.reorgs == ref.stats.reorgs
    assert port.stats.tuples_reclassified == ref.stats.tuples_reclassified
    assert port.stats.tuples_total_possible == ref.stats.tuples_total_possible
    assert port.disk_touches == ref.disk_touches
    for v in range(k):
        assert np.array_equal(np.sort(port.members(v)),
                              np.sort(ref.members(v)))
    assert np.array_equal(port.band_fractions(), ref.band_fractions())
    for i in range(0, ref.n, 41):
        assert np.array_equal(port.labels_of(i), ref.labels_of(i))
    assert port.check_consistent() and ref.check_consistent()


def test_exact_water_boundary_multiview():
    """Entity at hw of view 0 short-circuits positive; entity at lw of
    view 1 is reclassified (z == 0 labels +1); probe, batched probe and
    band agree on both packages."""
    F = np.array([[2.0], [1.0], [0.5], [-1.0], [-2.0]], np.float32)
    k = 2
    out = {}
    for name, eng in (("ref", R.MultiViewEngine(F, k, p=2.0, q=2.0,
                                                cost_mode="modeled")),
                      ("port", T.MultiViewEngine(F, k, p=2.0, q=2.0,
                                                 cost_mode="modeled",
                                                 device="cpu"))):
        W = np.ones((k, 1), np.float32)
        eng.W, eng.b = W.copy(), np.zeros(k)
        eng._reorganize_views(np.ones(k, bool))
        eng.apply_models(W, np.array([1.0, -1.0]))
        assert (eng.lw[0], eng.hw[0]) == (0.0, 1.0)
        assert (eng.lw[1], eng.hw[1]) == (-1.0, 0.0)
        assert eng.hybrid_label(0, 1) == (1, "water")
        lab, how = eng.hybrid_label(1, 3)
        assert lab == 1 and how != "water"
        batched = [tuple(map(tuple, eng.hybrid_labels_of(i)))
                   for i in range(5)]
        single = [[eng.hybrid_label(v, i) for v in range(k)]
                  for i in range(5)]
        labels = [[eng.label(v, i) for v in range(k)] for i in range(5)]
        assert eng.check_consistent()
        out[name] = (batched, single, labels, eng.all_members().tolist())
    assert out["port"] == out["ref"]


def test_per_view_pending_isolation():
    """A read of view v catches up only v; the cold views keep deferring
    and their state is untouched; the lazy waste lands on the read views
    and equals the reference's."""
    c = cora_like(scale=0.2)
    k = c.num_classes
    F = np.ascontiguousarray(c.features, np.float32)
    r = np.random.default_rng(7)
    W = r.normal(size=(k, F.shape[1])).astype(np.float32) * 0.1
    bias = r.normal(size=k) * 0.01
    ref = R.MultiViewEngine(F, k, p=2.0, q=2.0, policy="lazy",
                            cost_mode="modeled")
    port = T.MultiViewEngine(F, k, p=2.0, q=2.0, policy="lazy",
                             cost_mode="modeled", device="cpu")
    truth = np.where(F @ W.T - bias.astype(np.float32) >= 0, 1, -1)
    for eng in (ref, port):
        eng.apply_models(W, bias)
    before = port.labels_sorted.clone()
    assert port.label(2, 5) == ref.label(2, 5) == truth[5, 2]
    others = [v for v in range(k) if v != 2]
    assert not port.pending[2] and port.pending[others].all()
    for v in others:
        assert torch.equal(port.labels_sorted[v], before[v])
    mem = port.members(4)
    assert set(mem.tolist()) == set(ref.members(4).tolist()) == \
        set(np.flatnonzero(truth[:, 4] == 1).tolist())
    assert np.array_equal(port.pending, ref.pending)
    assert np.array_equal(port.lazy_waste, ref.lazy_waste)
    counts = port.all_members()
    assert np.array_equal(counts, ref.all_members())
    assert np.array_equal(counts, (truth == 1).sum(axis=0))
    assert not port.pending.any()
    assert np.array_equal(port.lazy_waste, ref.lazy_waste)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_carry_over_mid_stream(stream, policy):
    F, k, rounds = stream
    half = len(rounds) // 2
    ref = R.MultiViewEngine(F, k, p=2.0, q=2.0, policy=policy,
                            cost_mode="modeled", **POLICIES[policy])
    for W, b in rounds[:half]:
        ref.apply_models(W, b)
    port = multiview_from_reference(ref, device="cpu")
    assert np.array_equal(port.perm.numpy(), ref.perm)
    assert np.array_equal(port.eps_sorted.numpy(), ref.eps_sorted)
    assert np.array_equal(port.pos_count, ref.pos_count)
    if port.buffer_F is not None:
        for v in range(k):
            m = int(ref.buffer_hi[v] - ref.buffer_lo[v])
            assert np.array_equal(port.buffer_F[v, :m].numpy(),
                                  ref.buffer_F[v, :m])
    reorgs = ref.reorg_counts.sum()
    _run(ref, port, F, rounds[half:])
    assert_same_state(ref, port, F)
    assert ref.reorg_counts.sum() > reorgs
    assert port.stats.tuples_reclassified == ref.stats.tuples_reclassified
    assert port.check_consistent()


def test_storage_tier_waits():
    """The storage tier is in: `store=` attaches a `BufferPool` (no
    materialized hot-buffer rows), which the first reorganize warms."""
    from repro_torch.storage import BufferPool, EntityStore
    F = np.random.default_rng(0).normal(size=(8, 2)).astype(np.float32)
    pool = BufferPool(EntityStore.from_array(F, page_bytes=16), F.nbytes)
    eng = T.MultiViewEngine(F, 2, store=pool, buffer_frac=0.25,
                            device="cpu")
    assert eng.store is pool and eng.buffer_F is None
    assert pool.misses == 0 and len(pool._hot_pins) > 0
    assert len(pool.frames) == pool.store.num_pages == 4
    pool.store.close()
