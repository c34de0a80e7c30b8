"""The port's MoE layer (`repro_torch.models.moe`) against
`repro.models.moe` on the smoke twins of llama4-scout-17b-a16e (top-1,
one shared expert), dbrx-132b (top-2) and jamba-v0.1-52b (4 experts,
top-2), on the same weights (drawn by the reference, carried across as
numpy) and the same seeded inputs, in f32 and bf16.

Routing is held exactly: the kept slots (which token sits in which slot
of which expert's buffer; hence each expert's kept-token count and the
dropped routes) equal the reference's, read off its combine tensor. Both
route from the same input through an f32 router product, so only an f32
tie could part them, and these inputs hold none. y within 1e-5 (f32) and
2e-2 (bf16: both round the expert products to bf16, summing in different
orders); the aux loss, f32 on both sides, within 1e-5."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

import repro.models.moe as RM                               # noqa: E402
from repro.configs import get_config as jax_config         # noqa: E402
from repro.configs import smoke_config as jax_smoke         # noqa: E402
from repro.models.params import init_params as jax_init     # noqa: E402

from repro_torch.configs import get_config, smoke_config    # noqa: E402
from repro_torch.models import moe as M                     # noqa: E402

ARCHS = ("llama4-scout-17b-a16e", "dbrx-132b", "jamba-v0.1-52b")
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
AUX_TOL = dict(rtol=1e-5, atol=1e-5)
# (batch, tokens), and how the inputs are drawn: "normal" i.i.d.; "skewed"
# a shared direction plus a little noise, so most tokens pick the same
# expert and overflow its capacity; "decode" one token a sequence
CASES = {"normal": (2, 24), "skewed": (2, 32), "decode": (4, 1)}


def _cfgs(arch, dtype):
    return (dataclasses.replace(jax_smoke(arch), dtype=dtype,
                                param_dtype=dtype),
            dataclasses.replace(smoke_config(arch), dtype=dtype,
                                param_dtype=dtype))


def _t(a, dtype):
    """A jax or numpy array as a torch tensor of `dtype` (exact: bf16
    values pass through f32)."""
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _inputs(case, d, seed):
    b, s = CASES[case]
    rng = np.random.default_rng(seed)
    if case == "skewed":
        x = rng.normal(size=(1, 1, d)) + 0.1 * rng.normal(size=(b, s, d))
    else:
        x = rng.normal(size=(b, s, d))
    return x.astype(np.float32)


def _reference(monkeypatch, jp, jcfg, xj):
    """(y, aux, combine) of the reference's `moe`, its combine read where
    it passes through `logical_sharding` (a no-op without a mesh)."""
    seen = []

    def spy(x, axes, mesh=None, *args, **kwargs):
        if tuple(axes) == ("batch", None, "experts", None):
            seen.append(np.asarray(x))
        return x

    monkeypatch.setattr(RM, "logical_sharding", spy)
    y, aux = RM.moe(jp, jcfg, xj)
    assert len(seen) == 1
    return y, aux, seen[0]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_equals_reference(monkeypatch, arch, dtype, case):
    jcfg, cfg = _cfgs(arch, dtype)
    jp = jax_init(RM.moe_params(jcfg), 0)
    tdt = getattr(torch, dtype)
    p = {k: ({kk: _t(vv, tdt) for kk, vv in v.items()}
             if isinstance(v, dict) else _t(v, tdt)) for k, v in jp.items()}
    p["router"] = _t(jp["router"], torch.float32)
    x = _inputs(case, cfg.d_model, ARCHS.index(arch))
    xt = _t(x, tdt)
    want_y, want_aux, want_combine = _reference(
        monkeypatch, jp, jcfg, jnp.asarray(x).astype(dtype))

    y, aux = M.moe(p, cfg, xt)
    assert y.dtype == tdt and y.shape == xt.shape
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want_y, np.float32), **TOL[dtype])
    np.testing.assert_allclose(float(aux), float(want_aux), **AUX_TOL)

    r = M.route(p["router"], cfg, xt)
    b, s = CASES[case]
    C = M._capacity(cfg, s)
    assert r.combine.shape == want_combine.shape == (b, s, cfg.num_experts,
                                                     C)
    kept, want_kept = r.combine.numpy() > 0, want_combine > 0
    assert np.array_equal(kept, want_kept)
    np.testing.assert_array_equal(kept.sum((1, 3)), want_kept.sum((1, 3)))
    routes = b * s * cfg.num_experts_per_tok
    dropped = routes - int(kept.sum())
    assert dropped == routes - int(want_kept.sum())
    if case == "skewed":
        assert dropped > 0, "the skewed case must overflow a capacity"
    if case == "decode":
        assert C == 1 and dropped == 0
    np.testing.assert_allclose(r.combine.numpy(), want_combine,
                               **TOL["float32"])
    # each token's chosen experts are distinct, and its kept slots lie in
    # them
    ch = r.choices.numpy()
    assert all(len(set(t)) == len(t) for t in ch.reshape(-1, ch.shape[-1]))
    for g, t, e in zip(*np.nonzero(kept.any(-1))):
        assert e in ch[g, t]


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_equals_reference(arch):
    for cfg, jcfg in ((get_config(arch), jax_config(arch)),
                      (smoke_config(arch), jax_smoke(arch))):
        for s in list(range(1, 70)) + [255, 256, 2048, 32768]:
            assert M._capacity(cfg, s) == RM._capacity(jcfg, s), (arch, s)


def test_argmax_takes_the_first_maximum():
    """Equal router probabilities route to the lowest expert index, as
    `jnp.argmax` does: a zero router gives every expert 1/E."""
    cfg = smoke_config("dbrx-132b")
    E = cfg.num_experts
    x = torch.randn(2, 8, cfg.d_model)
    r = M.route(torch.zeros(cfg.d_model, E), cfg, x)
    assert torch.equal(r.choices[..., 0], torch.zeros(2, 8, dtype=torch.long))
    assert torch.equal(r.choices[..., 1], torch.ones(2, 8, dtype=torch.long))
