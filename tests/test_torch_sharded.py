"""The port's `ShardedMultiViewHazy(device="cpu")` against the JAX package's
(one-device mesh, interpret-mode Pallas kernel) and against the host
`MultiViewEngine`, over the cora_like stream of
tests/test_distributed.py (n = 2048, 300 inserts, seed 11).

The JAX driver passes `check_rep=False` to `shard_map`, which this
host's jax (0.9) no longer takes; the module fixture renames it to
`check_vma` on `repro.core.sharded.shard_map` for these tests only."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.sharded as ref_sharded                    # noqa: E402
from repro.core.multiview import MultiViewEngine           # noqa: E402
from repro.core.waters import holder_M as ref_holder_M     # noqa: E402
from repro.data import cora_like, multiclass_example_stream  # noqa: E402
from repro.launch.mesh import make_host_mesh                # noqa: E402

from repro_torch.core.sharded import ShardedMultiViewHazy  # noqa: E402
from repro_torch.core.waters import holder_M               # noqa: E402
from repro_torch.kernels.band_reclassify import kernel     # noqa: E402

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
        lr, l2 = 0.1, 1e-4
        stream = multiclass_example_stream(c, seed=SEED)
        launches0 = kernel.multiview_band_reclassify.launches
        for i, cls in (next(stream) for _ in range(INSERTS)):
            if i >= N:
                continue
            f = F[i]
            y = np.where(np.arange(k) == cls, 1.0, -1.0)
            z = W @ f - b.astype(np.float32)
            g = np.where(y * z.astype(np.float64) < 1.0, -y, 0.0)
            W = W * (1.0 - lr * l2)
            W -= (lr * g).astype(np.float32)[:, None] * f[None, :]
            b = b - lr * (-g)
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
