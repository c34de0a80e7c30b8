"""Parity of the port's Layer 1 primitives, host helpers and corpora with
the JAX package's: the same numpy inputs, made from a seed, go through
`repro.core.engine` and `repro_torch.core.engine`."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as E                         # noqa: E402
from repro.core.multiclass import sgd_all_views as ref_sgd  # noqa: E402
from repro.core.skiing import Skiing as RefSkiing, alpha_star as ref_alpha  # noqa: E402
from repro.core.waters import holder_M as ref_M, vector_norm as ref_norm  # noqa: E402
from repro import data as ref_data                         # noqa: E402

from repro_torch.core import engine as T                   # noqa: E402
from repro_torch.core.multiclass import sgd_all_views      # noqa: E402
from repro_torch.core.skiing import Skiing, alpha_star     # noqa: E402
from repro_torch.core.waters import holder_M, vector_norm  # noqa: E402
from repro_torch import data as port_data                  # noqa: E402

R = np.random.default_rng(7)
t = torch.from_numpy


def _eps(k, n, seed):
    return np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)


@pytest.mark.parametrize("case", ["empty", "full", "interior", "mixed"])
def test_covering_windows(case):
    k, n = 5, 257
    eps = _eps(k, n, 3)
    if case == "empty":          # every eps outside [lw, hw)
        lw = np.full(k, 10.0, np.float32)
        hw = np.full(k, 11.0, np.float32)
    elif case == "full":         # every eps inside
        lw = np.full(k, -10.0, np.float32)
        hw = np.full(k, 10.0, np.float32)
    elif case == "interior":
        lw = np.full(k, -0.05, np.float32)
        hw = np.full(k, 0.05, np.float32)
    else:                        # one empty, one full, one exact-bound view
        lw = np.array([10.0, -10.0, eps[2, 17], -0.3, 0.0], np.float32)
        hw = np.array([11.0, 10.0, eps[2, 200], 0.2, 0.0], np.float32)
    want = E.covering_windows(eps, lw, hw)
    got = T.covering_windows(t(eps), t(lw), t(hw))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)


def test_probe_partition_at_exact_waters():
    lw, hw = np.float32(-0.25), np.float32(0.5)
    eps = np.array([lw, hw, np.nextafter(lw, -1), np.nextafter(lw, 1),
                    np.nextafter(hw, -1), np.nextafter(hw, 1), 0.0, -0.0,
                    -3.0, 3.0], np.float32)
    want = E.probe_partition(eps, lw, hw)
    got = T.probe_partition(t(eps), torch.tensor(lw), torch.tensor(hw))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    host = T.host_probe_partition(eps, lw, hw)
    assert host.dtype == np.int8
    assert np.array_equal(host, want)
    assert np.array_equal(T.band_mask(t(eps), torch.tensor(lw),
                                      torch.tensor(hw)).numpy(),
                          E.band_mask(eps, lw, hw))


def test_host_probe_partition_at_f64_waters():
    """float64 host waters, each between two float32 values, with eps at
    and beside their float32 roundings: the host form equals the device
    form on the waters cast to float32."""
    k = 6
    lw = -np.abs(R.normal(size=k)) - 1e-9
    hw = np.abs(R.normal(size=k)) + 1e-9
    eps = _eps(k, 64, 9)
    for b in (lw, hw):
        b32 = b.astype(np.float32)
        eps[:, :3] = np.stack([b32, np.nextafter(b32, -np.inf),
                               np.nextafter(b32, np.inf)], axis=1)
        got = T.host_probe_partition(eps, lw[:, None], hw[:, None])
        want = T.probe_partition(t(eps), t(lw.astype(np.float32))[:, None],
                                 t(hw.astype(np.float32))[:, None])
        assert np.array_equal(got, want.numpy())
        assert set(np.unique(got)) == {-1, 0, 1}


@pytest.mark.parametrize("at", [0, 1, 50, 199, 200])
def test_band_partition_at_elements(at):
    eps = np.sort(_eps(1, 200, 5)[0])
    eps[60:70] = eps[60]                    # a run of ties
    lw = eps[min(at, 199)]
    hw = eps[60] if at < 60 else eps[199]
    lo, hi = E.band_partition(eps, lw, hw)
    tlo, thi = T.band_partition(t(eps), float(lw), float(hw))
    assert (int(tlo), int(thi)) == (int(lo), int(hi))


@pytest.mark.parametrize("rank", [1, 2])
def test_band_bounds_is_numpys_float64_search(rank):
    """float32 eps rows at float64 waters on, just above and just below
    elements (and past both ends): one search gives numpy's float64
    positions at either rank, and `band_windows` the reference's."""
    k = 1 if rank == 1 else 5
    eps = np.sort(_eps(k, 300, 9), axis=1)
    r = np.random.default_rng(3)
    at = r.integers(0, 300, (2, k))
    nudge = np.array([-1e-12, 0.0, 1e-12])[r.integers(0, 3, (2, k))]
    lw = np.take_along_axis(eps, at[:1].T, 1)[:, 0].astype(np.float64) \
        + nudge[0]
    hw = np.maximum(lw, np.take_along_axis(eps, at[1:].T, 1)[:, 0]
                    + nudge[1])
    lw[0], hw[-1] = -10.0, 10.0
    want = [E.band_partition(eps[v], lw[v], hw[v]) for v in range(k)]
    if rank == 1:
        lo, hi = T.band_bounds(t(eps[0]), float(lw[0]), float(hw[0]))
        assert (int(lo), int(hi)) == tuple(int(x) for x in want[0])
    else:
        lo, hi = T.band_bounds(t(eps), lw, hw)
        assert lo.shape == hi.shape == (k,)
        assert [(int(a), int(b)) for a, b in zip(lo, hi)] == \
            [tuple(int(x) for x in p) for p in want]
        wlo, whi = T.band_windows(t(eps), t(lw.astype(np.float32)),
                                  t(hw.astype(np.float32)))
        rlo, rhi = E.band_windows(eps, lw.astype(np.float32),
                                  hw.astype(np.float32))
        assert np.array_equal(wlo.numpy(), rlo)
        assert np.array_equal(whi.numpy(), rhi)


def test_classify_and_argsort_stable():
    z = np.array([0.0, -0.0, 1e-30, -1e-30, 2.0, -2.0], np.float32)
    assert np.array_equal(T.classify(t(z)).numpy(), E.classify(z))
    x = np.round(_eps(3, 100, 9), 1)        # many ties
    assert np.array_equal(T.argsort_stable(t(x), dim=1).numpy(),
                          E.argsort_stable(x, axis=1))


@pytest.mark.parametrize("p", [1.0, 2.0, math.inf, 3.0])
def test_row_norms_bit_identical(p):
    X = _eps(4, 33, 11)
    assert np.array_equal(T.row_norms(X, p), E.row_norms(X, p))
    assert vector_norm(X[0], p) == ref_norm(X[0], p)


@pytest.mark.parametrize("p", [1.0, 2.0, math.inf])
def test_waters_update_bit_identical(p):
    """A chain of rounds, as the driver runs it: W f32, b f64, stored b an
    f32 read back as f64. The waters must agree bit for bit."""
    r = np.random.default_rng(21)
    k, d = 7, 54
    M = float(r.uniform(1, 3))
    W_s = r.normal(size=(k, d)).astype(np.float32)
    b_s = r.normal(size=k).astype(np.float32).astype(np.float64)
    lw = hw = np.zeros(k)
    lw_r = hw_r = np.zeros(k)
    for _ in range(6):
        W = (W_s + 0.01 * r.normal(size=(k, d))).astype(np.float32)
        b = b_s + 0.01 * r.normal(size=k)
        lw, hw = T.waters_update(lw, hw, W, b, W_s, b_s, M, p)
        lw_r, hw_r = E.waters_update(lw_r, hw_r, W, b, W_s, b_s, M, p)
        assert lw.dtype == np.float64
        assert np.array_equal(lw.view(np.uint64), lw_r.view(np.uint64))
        assert np.array_equal(hw.view(np.uint64), hw_r.view(np.uint64))


def test_skiing_matches_reference():
    costs = np.random.default_rng(4).uniform(0, 0.3, 200)
    a, b = Skiing(S=1.0, alpha=0.7), RefSkiing(S=1.0, alpha=0.7)
    for c in costs:
        if a.should_reorganize():
            a.record_reorg()
        else:
            a.record_incremental(float(c))
        if b.should_reorganize():
            b.record_reorg()
        else:
            b.record_incremental(float(c))
        assert (a.a, a.reorgs, a.total_incremental) == \
               (b.a, b.reorgs, b.total_incremental)
    assert a.reorgs > 0 and a.total_cost == b.total_cost
    assert alpha_star(0.3) == ref_alpha(0.3)
    assert T.skiing_due(a.a, 0.7, 1.0) == E.skiing_due(b.a, 0.7, 1.0)


def test_sgd_all_views_bit_identical():
    c = ref_data.cora_like(scale=0.2)
    F = c.features
    k, d = c.num_classes, F.shape[1]
    W, b = np.zeros((k, d), np.float32), np.zeros(k)
    Wr, br = W.copy(), b.copy()
    r = np.random.default_rng(2)
    for _ in range(200):
        i = int(r.integers(0, F.shape[0]))
        W, b = sgd_all_views(W, b, F[i], int(c.classes[i]), lr=0.1, l2=1e-4)
        Wr, br = ref_sgd(Wr, br, F[i], int(c.classes[i]), lr=0.1, l2=1e-4)
    assert W.dtype == np.float32 and b.dtype == np.float64
    assert np.array_equal(W, Wr) and np.array_equal(b, br)
    assert holder_M(F, 2.0) == ref_M(F, 2.0)


@pytest.mark.parametrize("make", [
    lambda m: m.forest_like(scale=0.002),
    lambda m: m.dblife_like(scale=0.01, hash_dim=256),
    lambda m: m.citeseer_like(scale=0.002, hash_dim=512),
    lambda m: m.cora_like(),
    lambda m: m.multiclass_corpus("FC", 3000, 54, 7),
], ids=["forest", "dblife", "citeseer", "cora", "multiclass"])
def test_corpora_equal_for_equal_seeds(make):
    a, b = make(port_data), make(ref_data)
    for field in ("features", "labels", "true_w", "classes"):
        if hasattr(b, field):
            assert np.array_equal(getattr(a, field), getattr(b, field)), field
    if hasattr(b, "classes"):
        sa = port_data.multiclass_example_stream(a, seed=3)
        sb = ref_data.multiclass_example_stream(b, seed=3)
        assert [next(sa) for _ in range(50)] == [next(sb) for _ in range(50)]
    else:
        sa = port_data.example_stream(a, seed=3)
        sb = ref_data.example_stream(b, seed=3)
        for (i, f, y), (j, g, z) in zip((next(sa) for _ in range(50)),
                                        (next(sb) for _ in range(50))):
            assert i == j and y == z and np.array_equal(f, g)
