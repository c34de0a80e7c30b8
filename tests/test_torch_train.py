"""The port's training step (`models/steps.py`: `lm_loss`,
`make_train_step`, `init_train_state`, `batch_specs`,
`train_state_specs`; `optim/`; the per-layer rematerialization of
`models/transformer.py`) against the JAX package's on the CPU.

Every smoke twin (the ten registered families' reduced configs) in f32:
the reference's `init_train_state` carried across
(`core/convert.train_state_from_reference`), one `make_train_step` in
each package on the same seeded batch: loss, nll, aux, grad_norm and lr
within 1e-5, the new params, m and v within 1e-4, and the parameter
updates within 1e-3 of the reference's in norm. The bf16 twins by the
noise rule of tests/test_torch_lm.py (`NOISY`): the port's gradient (the
first moment m = 0.1 g) as close to the reference's f32 step on the same
weights as the reference's own bf16 step is, within 1.5x; the scalars
within 2e-2. Then remat "full" and "dots" against "none" (within 1e-6),
the analogues of tests/test_archs_smoke.py's train-step tests (the
microbatched step also against the reference's), of
tests/test_training_e2e.py's loss-decrease test (60 steps), and the
abstract specs of every full-size config against the reference's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS                # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES              # noqa: E402
from repro.configs import get_config as jax_config          # noqa: E402
from repro.configs import smoke_config as jax_smoke         # noqa: E402
from repro.models import build as jax_build                 # noqa: E402
from repro.models import steps as JS                        # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, get_config, smoke_config  # noqa: E402,E501
from repro_torch.core.convert import train_state_from_reference  # noqa: E402
from repro_torch.data import TokenStream                    # noqa: E402
from repro_torch.models import build                        # noqa: E402
from repro_torch.models import steps as S                   # noqa: E402
from repro_torch.models.params import DTYPES                # noqa: E402
from repro_torch.optim import tree_leaves                   # noqa: E402

B, SEQ = 2, 32
SCALARS = ("loss", "nll", "aux", "grad_norm", "lr")
NOISY = ("qwen3-14b", "llama4-scout-17b-a16e", "dbrx-132b",
         "jamba-v0.1-52b", "qwen1.5-32b")           # tests/test_torch_lm.py
NOISE_RATIO = 1.5


def _cfgs(arch, dtype, **over):
    over = dict(dtype=dtype, param_dtype=dtype, **over)
    return (dataclasses.replace(jax_smoke(arch), **over),
            dataclasses.replace(smoke_config(arch), **over))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, seed=0, b=B):
    """(reference batch, port batch): seeded tokens and targets, and f32
    `img_embeds` or `frames` where the family takes them."""
    r = np.random.default_rng(seed)
    arrays = {"tokens": r.integers(0, cfg.vocab_size, (b, SEQ)),
              "targets": r.integers(0, cfg.vocab_size, (b, SEQ))}
    arrays = {k: v.astype(np.int32) for k, v in arrays.items()}
    if cfg.family == "vlm":
        arrays["img_embeds"] = r.normal(
            size=(b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        arrays["frames"] = r.normal(
            size=(b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.tensor(v) for k, v in arrays.items()})


_JITTED = {}


def _ref_step(jm, state, batch):
    """The reference's jitted train step (compiled once per config: the
    bf16 tests' f32 anchors reuse the f32 tests' steps)."""
    if jm.cfg not in _JITTED:
        _JITTED[jm.cfg] = jax.jit(JS.make_train_step(jm))
    new, met = _JITTED[jm.cfg](state, batch)
    return _np(new), {k: float(v) for k, v in met.items()}


def _port_step(cfg, state_np, batch):
    state = train_state_from_reference(state_np, cfg, device="cpu")
    old = [p.detach().clone() for p in tree_leaves(state["params"])]
    new, met = S.make_train_step(build(cfg))(state, batch)
    return new, {k: float(v) for k, v in met.items()}, old


def _leaves(tree):
    """f32 numpy leaves of either package's tree, in the reference's
    order (`tree_leaves` sorts keys as jax.tree_util does)."""
    return [x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32) for x in tree_leaves(tree)]


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_train_step_f32_equals_reference(arch):
    jcfg, cfg = _cfgs(arch, "float32")
    jm = jax_build(jcfg)
    state = _np(JS.init_train_state(jm, 0))
    jb, tb = _batch(cfg)
    want, wmet = _ref_step(jm, state, jb)
    got, gmet, old = _port_step(cfg, state, tb)
    for k in SCALARS:
        np.testing.assert_allclose(gmet[k], wmet[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert int(got["step"]) == int(want["step"]) == 1
    assert int(got["opt"]["count"]) == 1
    for part in ("m", "v"):
        for g, w in zip(_leaves(got["opt"][part]),
                        _leaves(want["opt"][part])):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    g_new, w_new = _leaves(got["params"]), _leaves(want["params"])
    w_old = _leaves(state["params"])
    du_got = np.concatenate([(g - o.numpy()).ravel()
                             for g, o in zip(g_new, old)])
    du_want = np.concatenate([(w - o).ravel()
                              for w, o in zip(w_new, w_old)])
    for g, w in zip(g_new, w_new):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    assert np.linalg.norm(du_want) > 0
    assert (np.linalg.norm(du_got - du_want)
            <= 1e-3 * np.linalg.norm(du_want))


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_train_step_bf16_noise_rule(arch):
    """bf16: the gradient (m) by the noise rule against the reference's
    f32 step on the same weights; v and the scalars within 2e-2."""
    jcfg, cfg = _cfgs(arch, "bfloat16")
    jm = jax_build(jcfg)
    state = _np(JS.init_train_state(jm, 0))
    jb, tb = _batch(cfg)
    want, wmet = _ref_step(jm, state, jb)
    jm32 = jax_build(dataclasses.replace(jcfg, dtype="float32",
                                         param_dtype="float32"))
    state32 = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        if np.issubdtype(a.dtype, np.floating) or a.dtype.name == "bfloat16"
        else a, state)
    want32, _ = _ref_step(jm32, state32, jb)
    got, gmet, _ = _port_step(cfg, state, tb)
    for k in SCALARS:
        np.testing.assert_allclose(gmet[k], wmet[k], rtol=2e-2, atol=2e-2,
                                   err_msg=k)
    for leaf, spec in zip(tree_leaves(got["params"]),
                          tree_leaves(build(cfg).param_tree)):
        assert leaf.dtype == spec.dtype
        if spec.dtype != torch.float32:
            assert leaf.dtype == DTYPES["bfloat16"]
    m = [np.concatenate([x.ravel() for x in _leaves(t["opt"]["m"])])
         for t in (got, want, want32)]
    assert np.isfinite(m[0]).all()
    ratio = (np.linalg.norm(m[0] - m[2]) / np.linalg.norm(m[1] - m[2]))
    assert ratio <= NOISE_RATIO, ratio
    for g, w in zip(_leaves(got["opt"]["v"]), _leaves(want["opt"]["v"])):
        np.testing.assert_allclose(g, w, rtol=2e-2, atol=2e-2)


def _port_only_step(cfg, seed=0, **step_kw):
    state = S.init_train_state(build(cfg), seed, device="cpu")
    new, met = S.make_train_step(build(cfg), **step_kw)(state,
                                                        _batch(cfg)[1])
    return new, met


@pytest.mark.parametrize("arch,policy", [
    ("tinyllama-1.1b", "full"), ("tinyllama-1.1b", "dots"),
    ("whisper-tiny", "full"), ("jamba-v0.1-52b", "dots")])
def test_remat_gives_the_same_step(arch, policy):
    """Rematerialization changes what is kept for the backward, not the
    step: params, moments and metrics within 1e-6 of "none"."""
    _, cfg = _cfgs(arch, "float32")
    plain, pmet = _port_only_step(cfg)
    remat, rmet = _port_only_step(dataclasses.replace(cfg,
                                                      remat_policy=policy))
    for k in SCALARS:
        np.testing.assert_allclose(float(rmet[k]), float(pmet[k]),
                                   rtol=1e-6, atol=1e-6)
    for part in (("params",), ("opt", "m"), ("opt", "v")):
        a, b = remat, plain
        for key in part:
            a, b = a[key], b[key]
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)


def test_remat_recomputes_the_forward():
    """Under "full" the attention forward runs twice a layer (once more in
    the backward); serving (no_grad) is the plain call."""
    from repro_torch.kernels.flash_attention import ops
    _, cfg = _cfgs("tinyllama-1.1b", "float32")
    calls = []
    fwd = ops.FlashAttention.forward

    def counted(ctx, q, k, v):
        calls.append(1)
        return fwd(ctx, q, k, v)

    ops.FlashAttention.forward = staticmethod(counted)
    try:
        for policy, want in (("none", 1), ("full", 2)):
            calls.clear()
            _port_only_step(dataclasses.replace(cfg, remat_policy=policy))
            assert len(calls) == want * cfg.num_layers, (policy, calls)
    finally:
        ops.FlashAttention.forward = staticmethod(fwd)
    m = build(dataclasses.replace(cfg, remat_policy="full"))
    params = S.init_serving_params(m, device="cpu")
    batch = _batch(cfg)[1]
    with torch.no_grad():
        a, _ = m.forward(params, batch)
    b, _ = build(cfg).forward(params, batch)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step(arch):
    """tests/test_archs_smoke.py::test_train_step on the port: the smoke
    twin in its own dtype, one step, finite positive loss, step 1."""
    cfg = smoke_config(arch)
    state, met = _port_only_step(cfg)
    assert np.isfinite(float(met["loss"])) and float(met["loss"]) > 0
    assert np.isfinite(float(met["grad_norm"]))
    assert int(state["step"]) == 1
    assert all(p.requires_grad for p in tree_leaves(state["params"]))


def test_microbatched_train_matches_plain():
    """tests/test_archs_smoke.py::test_microbatched_train_matches_plain on
    the port, and the port's microbatched step against the reference's
    on the same state and batch (f32)."""
    cfg = smoke_config("granite-3-2b")
    s1, m1 = _port_only_step(cfg)
    s2, m2 = _port_only_step(dataclasses.replace(cfg, microbatches=2))
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-3
    g1, g2 = float(m1["grad_norm"]), float(m2["grad_norm"])
    assert abs(g1 - g2) / max(g1, 1e-6) < 0.05

    jcfg, cfg = _cfgs("granite-3-2b", "float32", microbatches=2)
    jm = jax_build(jcfg)
    state = _np(JS.init_train_state(jm, 0))
    jb, tb = _batch(cfg, seed=1, b=4)
    want, wmet = _ref_step(jm, state, jb)
    got, gmet, _ = _port_step(cfg, state, tb)
    for k in SCALARS:
        np.testing.assert_allclose(gmet[k], wmet[k], rtol=1e-5, atol=1e-5)
    for part in (("params",), ("opt", "m"), ("opt", "v")):
        a, b = got, want
        for key in part:
            a, b = a[key], b[key]
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4)


def test_tiny_lm_loss_decreases():
    """tests/test_training_e2e.py::test_tiny_lm_loss_decreases on the port:
    60 steps on the synthetic Markov stream learn its structure."""
    cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), num_layers=2,
                              d_model=64, d_ff=256, vocab_size=512)
    mdl = build(cfg)
    ds = TokenStream(vocab_size=cfg.vocab_size, batch=8, seq_len=32, seed=0)
    step = S.make_train_step(mdl, lr=3e-3, warmup=5, total_steps=60)
    state = S.init_train_state(mdl, device="cpu")
    losses = []
    for i in range(60):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.2, (first, last)


def test_init_train_state():
    """Params as `init_params` draws them (the serving params of the same
    seed), each requiring grad; zero f32 moments; int32 count and step."""
    mdl = build(smoke_config("granite-3-2b"))
    state = S.init_train_state(mdl, 3, device="cpu")
    serving = S.init_serving_params(mdl, 3, device="cpu")
    for p, q in zip(tree_leaves(state["params"]), tree_leaves(serving)):
        assert p.requires_grad and torch.equal(p.detach(), q)
    for part in ("m", "v"):
        for p, m in zip(tree_leaves(state["params"]),
                        tree_leaves(state["opt"][part])):
            assert m.dtype == torch.float32 and m.shape == p.shape
            assert not m.any()
    for x in (state["step"], state["opt"]["count"]):
        assert x.dtype == torch.int32 and x.shape == () and int(x) == 0


def _shapes(tree):
    """[(shape, dtype name)] of either package's tree, in the reference's
    leaf order."""
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in tree_leaves(tree)]


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_specs_equal_the_reference(arch):
    """`batch_specs` of every cell kind and `train_state_specs` of every
    full-size config: the reference's shapes and dtypes, on meta tensors
    (nothing allocated)."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name, shape in SHAPES.items():
        got = S.batch_specs(cfg, shape)
        want = JS.batch_specs(jcfg, JAX_SHAPES[name])
        assert sorted(got) == sorted(want), name
        for k in want:
            assert got[k].device.type == "meta"
            assert _shapes({k: got[k]}) == _shapes({k: want[k]}), (name, k)
    got = S.train_state_specs(build(cfg))
    want = JS.train_state_specs(jax_build(jcfg))
    assert sorted(got) == sorted(want) == ["opt", "params", "step"]
    assert all(x.device.type == "meta" for x in tree_leaves(got))
    assert _shapes(got) == _shapes(want)
