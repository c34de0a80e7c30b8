"""The port's Layer 2 (`repro_torch.core.engine`: `EngineState` and its
pure steps, device="cpu") against the reference's numpy functional core
(`repro.core.engine`, no jit) and the port's `MultiViewEngine` shell in
modeled mode: the torch leg of `tests/test_engine_core.py`'s
`_parity_trajectory`, its six fixed seeds and policies, over the same
random insert stream (N = 256, D = 16, K = 3, rows on the unit sphere,
p = q = 2, a catch-up every 7th round, three hybrid probes every 5th).
Each also starts once from the reference's own initial state carried
across by `convert.engine_state_from_reference`.

What must hold:
  * labels in entity order, catch-up counts and probe labels exact, but
    for a proven fp32 tie: |w·f − b| ≤ 1e-6·(‖f‖‖w‖ + |b|) in float64;
  * pending masks, reorg schedules and probe tiers exact;
  * waters `lw`, `hw` bit for bit (`assert_array_equal`)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.engine as E                               # noqa: E402

import repro_torch.core.engine as T                         # noqa: E402
from repro_torch.core.convert import engine_state_from_reference  # noqa: E402
from repro_torch.core.multiview import MultiViewEngine      # noqa: E402

N, D, K = 256, 16, 3
TIE_RTOL = 1e-6
CASES = [(11, "eager", 24), (12, "eager", 16), (21, "lazy", 24),
         (22, "lazy", 17), (31, "hybrid", 24), (32, "hybrid", 18)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _entity_order(labels, perm):
    labels, perm = np.asarray(labels), np.asarray(perm)
    out = np.empty_like(labels)
    for v in range(labels.shape[0]):
        out[v, perm[v]] = labels[v]
    return out


def _untied(got, want, F, W, b):
    """(k, n) or (k,)-for-one-row labels: the disagreements that are NOT
    proven fp32 ties of sign(F·W[v] − b[v])."""
    v, r = np.nonzero(np.atleast_2d(got != want))
    f = np.atleast_2d(F)[r].astype(np.float64)
    w = W[v].astype(np.float64)
    z = (f * w).sum(1) - b[v]
    tol = TIE_RTOL * (np.linalg.norm(f, axis=1) * np.linalg.norm(w, axis=1)
                      + np.abs(b[v]))
    return int((np.abs(z) > tol).sum()), int(v.size)


def _torch_trajectory(seed, policy, rounds, carried):
    r = np.random.default_rng(seed)
    F = r.normal(size=(N, D)).astype(np.float32)
    F /= np.maximum(np.linalg.norm(F, axis=1, keepdims=True), 1e-9)
    bf = 0.06 if policy == "hybrid" else 0.0
    shell = MultiViewEngine(F, K, p=2.0, q=2.0, alpha=1.0, policy=policy,
                            cost_mode="modeled", buffer_frac=bf,
                            device="cpu")
    rp = E.make_params(F, p=2.0, q=2.0, alpha=1.0, buffer_frac=bf)
    tp = T.make_params(F, p=2.0, q=2.0, alpha=1.0, buffer_frac=bf)
    assert tuple(tp) == tuple(rp)
    st_r = E.init_state(F, K, rp)
    st_t = (engine_state_from_reference(st_r, device="cpu") if carried
            else T.init_state(F, K, tp, device="cpu"))
    assert st_t.F.device.type == "cpu" and st_t.perm.dtype == torch.int64
    ones = np.ones(K, bool)
    W = np.zeros((K, D), np.float32)
    b = np.zeros(K, np.float64)
    reorg_r = np.zeros(K, np.int64)
    reorg_t = np.zeros(K, np.int64)

    def counts_agree(counts, st, label_ties):
        assert np.abs(np.asarray(counts) - st.pos_count).sum() <= label_ties

    for t in range(rounds):
        W = (W + r.normal(size=(K, D)) * 0.05).astype(np.float32)
        b = b + r.normal(size=K) * 0.02
        shell.apply_models(W, b)
        st_r, inf_r = E.apply_model(st_r, W, b, rp, policy=policy)
        st_t, inf_t = T.apply_model(st_t, W, b, tp, policy=policy)
        assert np.array_equal(inf_r["reorged"], inf_t["reorged"]), t
        assert np.array_equal(inf_r["widths"], inf_t["widths"]), t
        reorg_r += inf_r["reorged"]
        reorg_t += inf_t["reorged"]
        np.testing.assert_array_equal(st_t.lw, st_r.lw)
        np.testing.assert_array_equal(st_t.hw, st_r.hw)
        if t % 7 == 3:                       # All-Members read on all sides
            counts = shell.all_members()
            st_r, cr = E.catch_up(st_r, ones, rp)
            st_t, ct = T.catch_up(st_t, ones, tp)
            assert np.array_equal(cr["reorged"], ct["reorged"]), t
            assert np.array_equal(cr["caught_up"], ct["caught_up"]), t
            reorg_r += cr["reorged"]
            reorg_t += ct["reorged"]
            bad, n_diff = _untied(
                _entity_order(st_t.labels, st_t.perm),
                _entity_order(st_r.labels, st_r.perm), F, W, b)
            assert bad == 0, t
            counts_agree(counts, st_t, n_diff)
            counts_agree(st_r.pos_count, st_t, n_diff)
        if policy == "hybrid" and t % 5 == 2:
            for e in r.integers(0, N, 3):    # Fig. 8 probes on all sides
                labs, hows = shell.hybrid_labels_of(int(e))
                st_r, lr, tr = E.hybrid_probe(st_r, int(e), rp)
                st_t, lt, tt = T.hybrid_probe(st_t, int(e), tp)
                assert lt.dtype == np.int8 and tt.dtype == np.int8
                assert np.array_equal(tt, tr) and np.array_equal(tt, hows)
                for want in (lr, labs):
                    bad, _ = _untied(lt[:, None], want[:, None],
                                     F[int(e)][None], W, b)
                    assert bad == 0, (t, int(e))
            np.testing.assert_array_equal(st_t.lw, st_r.lw)

    counts = shell.all_members()             # final catch-up everywhere
    st_r, cr = E.catch_up(st_r, ones, rp)
    st_t, ct = T.catch_up(st_t, ones, tp)
    reorg_r += cr["reorged"]
    reorg_t += ct["reorged"]

    ent_t = _entity_order(st_t.labels.numpy(), st_t.perm.numpy())
    ent_shell = _entity_order(shell.labels_sorted.numpy(),
                              shell.perm.numpy())
    for want in (_entity_order(st_r.labels, st_r.perm), ent_shell):
        bad, n_diff = _untied(ent_t, want, F, W, b)
        assert bad == 0
        counts_agree(counts if want is ent_shell else st_r.pos_count, st_t,
                     n_diff)
    assert np.array_equal(st_t.pending, st_r.pending)
    assert np.array_equal(st_t.pending, shell.pending)
    # waters bit for bit against both the numpy core and the port's shell
    np.testing.assert_array_equal(st_t.lw, st_r.lw)
    np.testing.assert_array_equal(st_t.hw, st_r.hw)
    np.testing.assert_array_equal(st_t.lw, shell.lw)
    np.testing.assert_array_equal(st_t.hw, shell.hw)
    # identical reorg schedules on all three
    assert np.array_equal(reorg_t, reorg_r)
    assert np.array_equal(reorg_t, shell.reorg_counts)
    # the state stays the state: a consistent (k, n) clustering
    assert np.array_equal(
        st_t.pos_count, (st_t.labels == 1).sum(1).numpy())
    assert torch.equal(torch.gather(st_t.perm, 1, st_t.inv_perm),
                       torch.arange(N).expand(K, N))
    assert shell.check_consistent()
    return shell, st_t


@pytest.mark.parametrize("carried", [False, True],
                         ids=["init_state", "from_reference"])
@pytest.mark.parametrize("seed,policy,rounds", CASES)
def test_torch_core_matches_numpy_core_and_shell(seed, policy, rounds,
                                                 carried):
    shell, _ = _torch_trajectory(seed, policy, rounds, carried)
    assert shell.stats.rounds == rounds


def test_pure_steps_leave_their_input_state_alone():
    """A step returns a new state: the one it was handed keeps every
    field, host and device, as it was."""
    r = np.random.default_rng(5)
    F = r.normal(size=(N, D)).astype(np.float32)
    params = T.make_params(F, buffer_frac=0.05)
    st0 = T.init_state(F, K, params, device="cpu")
    snap = [f.clone() if isinstance(f, torch.Tensor) else np.copy(f)
            for f in st0]
    W = r.normal(size=(K, D)).astype(np.float32)
    b = r.normal(size=K)
    for policy in ("eager", "lazy", "hybrid"):
        st, _ = T.apply_model(st0, W, b, params, policy=policy)
        st, _ = T.catch_up(st, np.ones(K, bool), params)
        T.hybrid_probe(st, 7, params)
    for before, after in zip(snap, st0):
        if isinstance(before, torch.Tensor):
            assert torch.equal(before, after)
        else:
            assert np.array_equal(before, after)

