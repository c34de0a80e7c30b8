"""The port's `ShardedMultiViewHazy(device="cpu")` against the JAX package's
(one-device mesh, interpret-mode Pallas kernel) and against the host
`MultiViewEngine`, over the cora_like stream of
tests/test_distributed.py (n = 2048, 300 inserts, seed 11). A second
pair of drivers over the same stream reads points between rounds, right
after each reorganization, on an old and a new state in turn, and under
waters wide enough that the feature-row gather runs: the one-shard read
resolved on the host from its index of scratch positions.

The JAX driver passes `check_rep=False` to `shard_map`, which this
host's jax (0.9) no longer takes; the module fixture renames it to
`check_vma` on `repro.core.sharded.shard_map` for these tests only."""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.sharded as ref_sharded                    # noqa: E402
from repro.core.multiview import MultiViewEngine           # noqa: E402
from repro.core.waters import holder_M as ref_holder_M     # noqa: E402
from repro.data import cora_like, multiclass_example_stream  # noqa: E402
from repro.launch.mesh import make_host_mesh                # noqa: E402

from repro_torch.core.sharded import (ShardedMultiViewHazy,  # noqa: E402
                                     multiview_hybrid_probe)
from repro_torch.core.waters import holder_M               # noqa: E402
from repro_torch.kernels.band_reclassify import kernel     # noqa: E402
from repro_torch.obs import MetricsRegistry, Tracer         # noqa: E402

N, INSERTS, SEED = 2048, 300, 11


def shard_map_check_vma(mp):
    """Test-local shim: forward `check_rep` as `check_vma`."""
    orig = ref_sharded.shard_map

    def shim(*args, **kw):
        if "check_rep" in kw:
            kw["check_vma"] = kw.pop("check_rep")
        return orig(*args, **kw)

    mp.setattr(ref_sharded, "shard_map", shim)


def _entity_order(labels, gids):
    out = np.empty_like(labels)
    out[:, gids] = labels
    return out


def _sgd(W, b, f, cls, lr=0.1, l2=1e-4):
    """One hinge SGD step of every one-vs-all view on example (f, cls)."""
    y = np.where(np.arange(W.shape[0]) == cls, 1.0, -1.0)
    z = W @ f - b.astype(np.float32)
    g = np.where(y * z.astype(np.float64) < 1.0, -y, 0.0)
    W = W * (1.0 - lr * l2)
    W -= (lr * g).astype(np.float32)[:, None] * f[None, :]
    return W, b - lr * (-g)


@pytest.fixture(scope="module")
def run():
    with pytest.MonkeyPatch.context() as mp:
        shard_map_check_vma(mp)
        c = cora_like(scale=0.8)
        k = c.num_classes
        F = np.ascontiguousarray(c.features[:N])
        d = F.shape[1]
        host = MultiViewEngine(F, k, p=2.0, q=2.0, cost_mode="modeled")
        jx = ref_sharded.ShardedMultiViewHazy(
            mesh=make_host_mesh((1, 1)), n=N, d=d, k=k,
            M=ref_holder_M(F, 2.0), p=2.0, cap_frac=1 / 2)
        pt = ShardedMultiViewHazy(n=N, d=d, k=k, M=holder_M(F, 2.0), p=2.0,
                                  cap_frac=1 / 2, device="cpu")
        js, ps = jx.init_state(F), pt.init_state(F)
        W = np.zeros((k, d), np.float32)
        b = np.zeros(k, np.float64)
        stream = multiclass_example_stream(c, seed=SEED)
        launches0 = kernel.multiview_band_reclassify.launches
        for i, cls in (next(stream) for _ in range(INSERTS)):
            if i >= N:
                continue
            W, b = _sgd(W, b, F[i], cls)
            host.apply_models(W, b)
            js = jx.apply_models(js, W, b)
            ps = pt.apply_models(ps, W, b)
        probe_ids = list(range(0, N, 61))
        yield dict(
            k=k, F=F, W=W, b=b, host=host, jx=jx, pt=pt, js=js, ps=ps,
            launches=kernel.multiview_band_reclassify.launches - launches0,
            jprobe=[jx.hybrid_labels_of(js, W, b, i) for i in probe_ids],
            pprobe=[pt.hybrid_labels_of(ps, W, b, i) for i in probe_ids],
            probe_ids=probe_ids)


def test_labels_in_entity_order_equal(run):
    host, k = run["host"], run["k"]
    host_full = np.empty((k, N), np.int8)
    for v in range(k):
        host_full[v, host.perm[v]] = host.labels_sorted[v]
    js, ps = run["js"], run["ps"]
    jlab = _entity_order(np.asarray(js.labels), np.asarray(js.gids))
    plab = _entity_order(ps.labels.numpy(), ps.gids.numpy())
    assert ps.labels.dtype == torch.int8
    assert np.array_equal(plab, jlab)
    assert np.array_equal(plab, host_full)


def test_counts_equal(run):
    counts = run["pt"].all_members(run["ps"])
    assert np.array_equal(counts, run["jx"].all_members(run["js"]))
    assert np.array_equal(counts, run["host"].all_members())
    assert counts.min() > 0 and counts.max() < N


def test_reorgs_and_overflows_equal(run):
    jx, pt = run["jx"], run["pt"]
    assert pt.skiing.reorgs == jx.skiing.reorgs >= 1
    assert pt.overflows == jx.overflows >= 1
    assert pt.skiing.a == jx.skiing.a
    assert pt.skiing.total_incremental == jx.skiing.total_incremental > 0
    # on the CPU the plain version runs: the CUDA kernel never launched
    assert run["launches"] == 0


def test_waters_bit_identical(run):
    jx, pt = run["jx"], run["pt"]
    assert pt.lw.dtype == np.float64
    assert np.array_equal(pt.lw.view(np.uint64), jx.lw.view(np.uint64))
    assert np.array_equal(pt.hw.view(np.uint64), jx.hw.view(np.uint64))
    assert np.array_equal(run["ps"].b_stored.numpy(),
                          np.asarray(run["js"].b_stored))
    assert run["ps"].b_stored.dtype == torch.float32


def test_eps_in_entity_order_close(run):
    js, ps = run["js"], run["ps"]
    jeps = _entity_order(np.asarray(js.eps), np.asarray(js.gids))
    peps = _entity_order(ps.eps.numpy(), ps.gids.numpy())
    np.testing.assert_allclose(peps, jeps, rtol=1e-6, atol=1e-6)


def test_hybrid_probe_equal(run):
    host = run["host"]
    resolved_total = 0
    for i, (jl, jr), (pl, pr) in zip(run["probe_ids"], run["jprobe"],
                                     run["pprobe"]):
        assert pl.dtype == np.int8
        assert np.array_equal(pl, jl), i
        assert np.array_equal(pr, np.asarray(jr)), i
        assert np.array_equal(pl, host.labels_of(i)), i
        resolved_total += int(pr.sum())
    assert resolved_total > 0          # the waters tier did real work


# ---------------------------------------------------------------------------
# point reads interleaved with reorganizations (the host index)
# ---------------------------------------------------------------------------

READS = [0, 1, 613, N - 2, N - 1]
INTERLEAVED, FORCE_EVERY = 200, 20


@contextlib.contextmanager
def _wide_waters(drivers, eps):
    """Both drivers' waters set to ∓ the median |eps| of each view, so
    about half of each view's rows lie in the band and reads gather;
    restored on exit."""
    q = np.quantile(np.abs(eps), 0.5, axis=1).astype(np.float64)
    kept = [(d.lw, d.hw) for d in drivers]
    for d in drivers:
        d.lw, d.hw = -q, q.copy()
    try:
        yield
    finally:
        for d, (lw, hw) in zip(drivers, kept):
            d.lw, d.hw = lw, hw


@pytest.fixture(scope="module")
def interleaved():
    """The JAX driver and the port's (armed with a tracer) at a capacity
    of an eighth of the rows, so windows overflow, with a reorganization
    forced every `FORCE_EVERY` inserts. Groups of point reads of `READS`
    (each: kind, entity, JAX labels and mask, the port's, the index builds
    the group made): every 10th round, right after each reorganization,
    then on the old and the new state in turn, then the new again; under
    wide waters on both; and `labels_of` of both states (the new against
    the JAX state, the old against its own labels in entity order)."""
    with pytest.MonkeyPatch.context() as mp:
        shard_map_check_vma(mp)
        c = cora_like(scale=0.8)
        k = c.num_classes
        F = np.ascontiguousarray(c.features[:N])
        d = F.shape[1]
        tr = Tracer(MetricsRegistry())
        jx = ref_sharded.ShardedMultiViewHazy(
            mesh=make_host_mesh((1, 1)), n=N, d=d, k=k,
            M=ref_holder_M(F, 2.0), p=2.0, cap_frac=1 / 8)
        pt = ShardedMultiViewHazy(n=N, d=d, k=k, M=holder_M(F, 2.0), p=2.0,
                                  cap_frac=1 / 8, device="cpu", tracer=tr)
        js, ps = jx.init_state(F), pt.init_state(F)
        W = np.zeros((k, d), np.float32)
        b = np.zeros(k, np.float64)
        groups = []

        def builds():
            return tr.metrics.counter("read.index_builds").value

        def read(kind, jstate, pstate, ids=READS):
            n0, rows = builds(), []
            for i in ids:
                jl, jr = jx.hybrid_labels_of(jstate, W, b, i)
                pl, pr = pt.hybrid_labels_of(pstate, W, b, i)
                rows.append((i, np.asarray(jl), np.asarray(jr), pl, pr))
            groups.append((kind, rows, builds() - n0))

        def labels(kind, want, pstate):
            n0 = builds()
            want = _entity_order(np.asarray(want.labels),
                                 np.asarray(want.gids))
            rows = [(i, want[:, i], pt.labels_of(pstate, i)) for i in READS]
            groups.append((kind, rows, builds() - n0))

        stream = multiclass_example_stream(c, seed=SEED)
        forced = 0
        for j in range(INTERLEAVED):
            i, cls = next(stream)
            if i >= N:
                continue
            W, b = _sgd(W, b, F[i], cls)
            force = j % FORCE_EVERY == FORCE_EVERY - 1
            if force:
                forced += 1
                for drv in (jx, pt):
                    drv.skiing.should_reorganize = lambda: True
            reorgs = pt.skiing.reorgs
            js_old, ps_old = js, ps
            js, ps = jx.apply_models(js, W, b), pt.apply_models(ps, W, b)
            if force:
                for drv in (jx, pt):
                    del drv.skiing.should_reorganize
            if pt.skiing.reorgs == reorgs:
                assert ps.gids is ps_old.gids      # a round keeps the order
                if j % 10 == 0:
                    read("round", js, ps)
                continue
            assert ps.gids is not ps_old.gids
            read("after", js, ps)
            for jstate, pstate in [(js_old, ps_old), (js, ps)] * 2:
                read("alternate", jstate, pstate)
            read("same", js, ps)
            with _wide_waters((jx, pt), ps.eps.numpy()):
                read("wide", js, ps, READS + list(range(3, N, 97)))
                read("wide old", js_old, ps_old)
            # the round that overflowed relabeled the old state's labels
            # in place (the JAX state keeps its own): held to its own order
            labels("labels old", ps_old, ps_old)
            labels("labels", js, ps)
        yield dict(groups=groups, forced=forced, jx=jx, pt=pt, js=js,
                   ps=ps, W=W, b=b, tr=tr)


def _reads(interleaved, *kinds):
    return [(kind, row) for kind, rows, _ in interleaved["groups"]
            if kind in kinds for row in rows]


def test_interleaved_reorganizations_and_overflows(interleaved):
    pt = interleaved["pt"]
    assert pt.skiing.reorgs == interleaved["jx"].skiing.reorgs
    assert pt.skiing.reorgs > interleaved["forced"] >= 5
    assert pt.overflows == interleaved["jx"].overflows >= 1


@pytest.mark.parametrize("kinds", [
    ("round",), ("after", "same"), ("alternate",), ("wide", "wide old")])
def test_host_read_equals_reference(interleaved, kinds):
    """Labels and water-resolved masks equal the JAX driver's read of the
    same state: between rounds, right after each reorganization or
    overflow, on old and new states in turn, and under wide waters."""
    reads = _reads(interleaved, *kinds)
    assert {i for _, (i, *_) in reads} >= {0, N - 1}
    for kind, (i, jl, jr, pl, pr) in reads:
        assert pl.dtype == np.int8 and pr.dtype == bool
        assert np.array_equal(pl, jl), (kind, i)
        assert np.array_equal(pr, jr), (kind, i)


def test_wide_waters_take_the_gather(interleaved):
    masks = [pr for _, (_, _, _, _, pr) in _reads(interleaved, "wide",
                                                  "wide old")]
    gathered = sum(not m.all() for m in masks)
    assert 0 < gathered < len(masks)
    assert 0 < sum(int(m.sum()) for m in masks)


def test_labels_of_after_reorganization(interleaved):
    rows = _reads(interleaved, "labels", "labels old")
    assert rows
    for kind, (i, want, got) in rows:
        assert got.dtype == np.int8
        assert np.array_equal(got, want), (kind, i)


def test_index_builds_once_per_new_gids(interleaved):
    """Each group of reads of another `gids` than the last read's builds
    the index once; a group of the same state builds nothing."""
    groups = interleaved["groups"]
    new_gids = {"after", "alternate", "wide old", "labels"}
    for kind, _, n in groups:
        assert n == (kind in new_gids), kind
    total = interleaved["tr"].metrics.counter("read.index_builds").value
    assert total == sum(n for _, _, n in groups)


def test_water_resolved_read_makes_one_transfer(interleaved):
    """A water-resolved read on one shard: one `read.sync` (the entity's
    eps), no `aten::item` (a 0-dim index) and no search (`eq`, `argmax`);
    the device probe it replaced does search."""
    pt, ps, W, b = (interleaved[k] for k in ("pt", "ps", "W", "b"))
    syncs = interleaved["tr"].metrics.histogram("span.read.sync.seconds")
    searched = {"aten::item", "aten::_local_scalar_dense", "aten::eq",
                "aten::argmax"}
    ids = [i for i in range(0, N, 7)
           if pt.hybrid_labels_of(ps, W, b, i)[1].all()][:8]
    assert ids
    for i in ids:
        n0 = syncs.count
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _, resolved = pt.hybrid_labels_of(ps, W, b, i)
        assert resolved.all()
        assert syncs.count - n0 == 1
        assert not {e.name for e in prof.events()} & searched
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        multiview_hybrid_probe(ps, ids[0])
    assert "aten::eq" in {e.name for e in prof.events()}
