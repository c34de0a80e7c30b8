"""The port's view API against the reference's, over one seeded stream
each: `ClassificationView` (hazy under eager, lazy and hybrid, and the
naive engine), `MulticlassView` (vectorized over `MultiViewEngine`, and
the per-class loop over `HazyEngine` or `NaiveEngine`),
`RandomFeatures` / `gaussian_kernel`, and the three host facades
(`SingleViewFacade`, `DerivedViewFacade`, `MultiViewFacade`), every read
method of a facade against the reference facade's. The port runs with
device="cpu" (the kernels' plain versions), cost_mode="modeled".

What must hold: models bit for bit (training is the same host numpy);
labels, counts, members, predictions, probe answers and tiers, waters,
pending masks, band widths, reorg counts and top-k ids exact (ROADMAP's
tie rule, |w·f − b| ≤ 1e-6·(‖f‖‖w‖ + |b|), never needed on these
streams); `RandomFeatures` bit for bit; margins from the host table bit
for bit; `cost_stats` equal in every modeled field (the measured fields
are wall times)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R                                      # noqa: E402
from repro.core import facade as RF                         # noqa: E402
from repro.core import random_features as RR                # noqa: E402
from repro.data import (cora_like, example_stream, forest_like,  # noqa: E402
                        multiclass_example_stream)

import repro_torch.core as T                                # noqa: E402
from repro_torch.core import engine as TE                   # noqa: E402
from repro_torch.core import facade as TF                   # noqa: E402
from repro_torch.core import random_features as TR          # noqa: E402

CPU = dict(device="cpu")
MODELED = ("S_model", "alpha", "acc", "reorgs_modeled", "charge_modeled",
           "view", "policy", "cost_mode", "lazy_waste")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _single_views(policy, engine="hazy", scale=0.005, **kw):
    corpus = forest_like(scale=scale)
    opts = dict(policy=policy, norm=(2.0, 2.0), lr=0.05, engine=engine,
                cost_mode="modeled", **kw)
    return (corpus, R.ClassificationView(corpus.features, **opts),
            T.ClassificationView(corpus.features, **CPU, **opts))


def _same_reads(ref, port, n, step=37):
    assert np.array_equal(port.model.w, ref.model.w)
    assert port.model.b == ref.model.b
    assert port.all_members() == ref.all_members()
    if hasattr(ref.engine, "members"):          # NaiveEngine has none
        assert np.array_equal(np.sort(port.members()),
                              np.sort(ref.members()))
    assert [port.label(i) for i in range(0, n, step)] == \
        [ref.label(i) for i in range(0, n, step)]


@pytest.mark.parametrize("policy,engine", [
    ("eager", "hazy"), ("lazy", "hazy"), ("hybrid", "hazy"),
    ("eager", "naive"), ("hybrid", "naive")])
def test_classification_view_matches_reference(policy, engine):
    corpus, ref, port = _single_views(policy, engine, buffer_frac=0.05)
    n = corpus.features.shape[0]
    stream = example_stream(corpus, seed=1, label_noise=0.0)
    rows = [next(stream) for _ in range(360)]
    for j, (i, _f, y) in enumerate(rows[:120]):
        ref.insert_example(i, y)
        port.insert_example(i, y)
        if j % 40 == 39:
            _same_reads(ref, port, n)
    for lo in range(120, 360, 40):
        ids = [i for i, _, _ in rows[lo:lo + 40]]
        ys = [y for _, _, y in rows[lo:lo + 40]]
        batched = lo % 80 == 0
        ref.insert_examples(ids, ys, batched=batched)
        port.insert_examples(ids, ys, batched=batched)
        _same_reads(ref, port, n)
    feats = corpus.features[[0, 5, 9]] * 0.5
    ref.insert_examples([0, 5, 9], [1.0, -1.0, 1.0], features=feats)
    port.insert_examples([0, 5, 9], [1.0, -1.0, 1.0], features=feats)
    _same_reads(ref, port, n, step=7)
    assert port.engine.check_consistent() if engine == "hazy" else True
    if engine == "hazy":
        assert port.engine.skiing.reorgs == ref.engine.skiing.reorgs


def test_retrain_from_scratch_matches_reference():
    corpus, ref, port = _single_views("eager")
    stream = example_stream(corpus, seed=2, label_noise=0.0)
    for i, _f, y in (next(stream) for _ in range(150)):
        ref.insert_example(i, y)
        port.insert_example(i, y)
    ref.retrain_from_scratch()
    port.retrain_from_scratch()
    _same_reads(ref, port, corpus.features.shape[0])
    assert port.engine.skiing.reorgs == ref.engine.skiing.reorgs
    assert port.engine.check_consistent()


def test_refresh_features_matches_and_keeps_ctor_params():
    corpus = forest_like(scale=0.003)
    for mod, kw in ((R, {}), (T, CPU)):
        scale = {"v": 1.0}

        def feature_fn(X, scale=scale):
            return np.asarray(X, np.float32) * scale["v"]

        view = mod.ClassificationView(corpus.features, feature_fn=feature_fn,
                                      policy="lazy", norm=(2.0, 2.0),
                                      alpha=1.3, cost_mode="modeled",
                                      touch_ns=123.0, lr=0.05, **kw)
        stream = example_stream(corpus, seed=3, label_noise=0.0)
        for i, _f, y in (next(stream) for _ in range(100)):
            view.insert_example(i, y)
        scale["v"] = 2.0
        view.refresh_features()
        assert view.engine.M == R.holder_M(corpus.features * 2.0, 2.0)
        assert view.engine.touch_ns == 123.0
        assert view.engine.policy == "lazy"
        assert view.engine.skiing.alpha == 1.3
        if mod is R:
            ref = view
    assert view.all_members() == ref.all_members()
    assert np.array_equal(np.sort(view.members()), np.sort(ref.members()))


def test_storage_tier_waits_or_is_refused():
    """`store=` reaches the hazy engine of a `ClassificationView` and the
    vectorized engine of a `MulticlassView`; the naive engine and the
    per-class loop refuse it, as the reference's do."""
    from repro_torch.storage import BufferPool, EntityStore
    F = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    store = EntityStore.from_array(F, page_bytes=64)
    pool = BufferPool(store, F.nbytes)
    assert T.ClassificationView(F, store=pool, **CPU).engine.store is pool
    with pytest.raises(ValueError, match="requires engine='hazy'"):
        T.ClassificationView(F, engine="naive", store=object(), **CPU)
    pool = BufferPool(store, F.nbytes)
    assert T.MulticlassView(F, 3, store=pool, **CPU).engine.store is pool
    with pytest.raises(ValueError, match="vectorized"):
        T.MulticlassView(F, 3, vectorized=False, store=object(), **CPU)
    store.close()


MULTICLASS = [("vectorized", dict()), ("loop-hazy", dict(vectorized=False)),
              ("loop-naive", dict(vectorized=False, engine="naive"))]


@pytest.mark.parametrize("policy", ["eager", "hybrid"])
@pytest.mark.parametrize("name,kw", MULTICLASS, ids=[m for m, _ in MULTICLASS])
def test_multiclass_view_matches_reference(name, kw, policy):
    c = cora_like(scale=0.15)
    k = c.num_classes
    opts = dict(policy=policy, p=2.0, q=2.0, lr=0.1, cost_mode="modeled",
                **kw)
    ref = R.MulticlassView(c.features, k, **opts)
    port = T.MulticlassView(c.features, k, **CPU, **opts)
    stream = multiclass_example_stream(c, seed=11)
    n = c.features.shape[0]
    for j in range(6):
        batch = [next(stream) for _ in range(20)]
        if j % 2:
            ref.insert_examples(*zip(*batch))
            port.insert_examples(*zip(*batch))
        else:
            for i, cls in batch:
                ref.insert_example(i, cls)
                port.insert_example(i, cls)
        for a, b in zip(port.models, ref.models):
            assert np.array_equal(a.w, b.w) and a.b == b.b
        assert port.class_counts() == ref.class_counts()
        ids = list(range(0, n, 11))
        assert np.array_equal(port.predict_batch(ids), ref.predict_batch(ids))
        for i in ids[::3]:
            assert port.predict(i) == ref.predict(i)
            assert np.array_equal(port.view_labels(i), ref.view_labels(i))
            assert np.array_equal(port.hybrid_view_labels(i),
                                  ref.hybrid_view_labels(i))
            assert port.predict_via_views(i) == ref.predict_via_views(i) \
                == port.predict(i)
    assert port.check_consistent() and ref.check_consistent()


@pytest.mark.parametrize("engine", ["hazy", "naive"])
def test_per_class_engines_share_one_table(engine):
    """The per-class loop's k engines read one device copy of F (the
    reference's engines share one numpy table); each keeps its own order."""
    F = cora_like(scale=0.15).features
    mc = T.MulticlassView(F, 3, vectorized=False, engine=engine, **CPU)
    table = mc.engines[0].F
    assert np.array_equal(table.numpy(), F)
    assert all(e.F is table for e in mc.engines)
    if engine == "hazy":
        assert len({e.F_sorted.data_ptr() for e in mc.engines}) == 3
    with pytest.raises(ValueError, match="features_on_device"):
        T.HazyEngine(F, features_on_device=table[:-1], **CPU)


def test_random_features_bit_for_bit():
    r = np.random.default_rng(4)
    X = r.normal(size=(50, 6)).astype(np.float32)
    for seed, sigma in ((0, 1.0), (7, 0.5)):
        a = TR.RandomFeatures(6, 128, sigma=sigma, seed=seed)
        b = RR.RandomFeatures(6, 128, sigma=sigma, seed=seed)
        assert np.array_equal(a.W, b.W) and np.array_equal(a.u, b.u)
        assert a.scale == b.scale
        assert np.array_equal(a(X), b(X)) and a(X).dtype == b(X).dtype
    assert np.array_equal(TR.gaussian_kernel(X[:10], X[5:20], 0.7),
                          RR.gaussian_kernel(X[:10], X[5:20], 0.7))
    assert T.RandomFeatures is TR.RandomFeatures


def test_hot_buffer_window_matches_reference():
    from repro.core.engine import hot_buffer_window as ref_window
    eps = np.array([-3.0, -1.0, -0.5, 0.25, 2.0, 4.0], np.float32)
    for cap in (2, 100, 0, 3):
        lo, hi = TE.hot_buffer_window(torch.tensor(eps), cap)
        assert (int(lo), int(hi)) == tuple(map(int, ref_window(eps, cap)))
    rows = torch.tensor(np.stack([eps, eps - 1.0, eps + 5.0]))
    lo, hi = TE.hot_buffer_window(rows, 2)
    assert [(int(a), int(b)) for a, b in zip(lo, hi)] == \
        [tuple(map(int, ref_window(r.numpy(), 2))) for r in rows]
    assert TE.PROBE_TIERS == ("water", "buffer", "disk", "pool")


def _facade_reads(fac, n, k):
    """Every read method of a facade, as plain values."""
    out = {}
    ids = list(range(0, n, 29))
    out["label"] = [fac.label(i, i % k) for i in ids]
    out["point_label"] = [fac.point_label(i, i % k) for i in ids]
    out["point_labels_of"] = [(lab.tolist(), hows) for lab, hows in
                              (fac.point_labels_of(i) for i in ids)]
    out["labels_of"] = [fac.labels_of(i).tolist() for i in ids]
    out["counts"] = fac.counts().tolist()
    out["members"] = [np.sort(fac.members(v, pos)).tolist()
                      for v in range(k) for pos in (True, False)]
    out["predict"] = [fac.predict(i) for i in ids]
    out["margin"] = [fac.margin(i, i % k) for i in ids]
    try:                  # MultiViewFacade has none, in both packages
        out["margins_of"] = fac.margins_of(ids).tolist()
    except NotImplementedError:
        out["margins_of"] = "not implemented"
    out["waters"] = [w.tolist() for w in fac.waters()]
    out["pending"] = fac.pending().tolist()
    out["band_info"] = [fac.band_info(v) for v in range(k)]
    out["top_margins"] = [
        (ids_.tolist(), z.tolist(), touched)
        for v in range(k) for desc in (True, False)
        for ids_, z, touched in [fac.top_margins(v, 5, desc)]]
    out["cost"] = [{key: row[key] for key in MODELED if key in row}
                   for row in fac.cost_stats()]
    snap = fac.telemetry_snapshot()
    out["telemetry"] = {key: snap[key] for key in
                        ("policy", "num_views", "tier_hits", "disk_touches")}
    out["storage"] = (fac.storage_stats(), fac.prefetcher_stats(),
                      fac.prefetch_band(0))
    return out


@pytest.mark.parametrize("policy", ["eager", "lazy", "hybrid"])
def test_single_view_facade_matches_reference(policy):
    corpus = forest_like(scale=0.004)
    n = corpus.features.shape[0]
    opts = dict(policy=policy, norm=(2.0, 2.0), lr=0.05, buffer_frac=0.05,
                cost_mode="modeled")
    ref = RF.SingleViewFacade(R.ClassificationView(corpus.features, **opts))
    port = TF.SingleViewFacade(T.ClassificationView(corpus.features, **CPU,
                                                    **opts))
    stream = example_stream(corpus, seed=5, label_noise=0.1)
    for j in range(8):
        batch = [next(stream) for _ in range(25)]
        ids, ys = [i for i, _, _ in batch], [y for _, _, y in batch]
        for fac in (ref, port):
            fac.insert_examples(ids, ys)
        # pending reads first: band_info/top_margins on prospective waters
        assert port.band_info() == ref.band_info()
        assert port.pending().tolist() == ref.pending().tolist()
        assert _facade_reads(port, n, 1) == _facade_reads(ref, n, 1)
    for fac in (ref, port):
        fac.force_round()
    victim = ids[0]
    assert port.delete_examples(victim) == ref.delete_examples(victim) > 0
    assert _facade_reads(port, n, 1) == _facade_reads(ref, n, 1)
    assert port.view.engine.check_consistent()


def test_derived_view_facade_matches_reference():
    corpus = forest_like(scale=0.004)
    n = corpus.features.shape[0]
    r = np.random.default_rng(9)
    col = r.normal(size=(n, 1)).astype(np.float32)
    opts = dict(policy="eager", norm=(2.0, 2.0), lr=0.05,
                cost_mode="modeled")
    ref = RF.DerivedViewFacade(R.ClassificationView(col, **opts), "parent")
    port = TF.DerivedViewFacade(T.ClassificationView(col, **CPU, **opts),
                                "parent")
    for j in range(3):
        ids = r.integers(0, n, 20).tolist()
        ys = np.where(col[ids, 0] > 0.1, 1.0, -1.0).tolist()
        pinned = col[ids] + 0.01 * j
        for fac in (ref, port):
            fac.insert_examples(ids, ys, features=pinned)
        assert _facade_reads(port, n, 1) == _facade_reads(ref, n, 1)
    col2 = col * 1.5 + 0.2
    for fac in (ref, port):
        fac.refresh_features(col2)
    assert (port.n, port.d) == (ref.n, ref.d)
    assert _facade_reads(port, n, 1) == _facade_reads(ref, n, 1)
    assert port.source == "parent"
    with pytest.raises(NotImplementedError):
        port.delete_examples(0)


@pytest.mark.parametrize("policy", ["eager", "lazy", "hybrid"])
def test_multi_view_facade_matches_reference(policy):
    c = cora_like(scale=0.12)
    k, n = c.num_classes, c.features.shape[0]
    opts = dict(policy=policy, p=2.0, q=2.0, lr=0.1, cost_mode="modeled",
                buffer_frac=0.05)
    ref = RF.MultiViewFacade(R.MulticlassView(c.features, k, **opts))
    port = TF.MultiViewFacade(T.MulticlassView(c.features, k, **CPU, **opts))
    stream = multiclass_example_stream(c, seed=13)
    for j in range(8):
        batch = [next(stream) for _ in range(16)]
        for fac in (ref, port):
            fac.insert_examples(*zip(*batch))
        assert [port.band_info(v) for v in range(k)] == \
            [ref.band_info(v) for v in range(k)]
        assert _facade_reads(port, n, k) == _facade_reads(ref, n, k)
    for fac in (ref, port):
        fac.force_round()
    assert _facade_reads(port, n, k) == _facade_reads(ref, n, k)
    assert port.tier_hits == ref.tier_hits
    assert port.mc.check_consistent()
    with pytest.raises(NotImplementedError):
        port.delete_examples(0)
