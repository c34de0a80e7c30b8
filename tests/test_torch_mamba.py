"""The port's mamba block (`repro_torch.models.mamba`) against
`repro.models.mamba` on jamba-v0.1-52b's smoke twin (d 64, d_inner 128,
d_state 16, conv 4, dt_rank 4), on the same weights (drawn by the
reference, carried across as numpy) and the same seeded inputs.

Tolerances: f32 within 1e-5. The port scans a chunk by doubling and the
reference by `lax.associative_scan`: the two multiply the decays in
different orders, which moves a product of c factors by up to some c
ulps, well inside 1e-5 at these chunks (c ≤ 64); the decode recurrence
multiplies them one at a time, in the reference's order. bf16 within 2e-2: both round the conv
taps, silu and the projections to bf16, the port after each operation
and XLA where its fusions end."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

import repro.models.mamba as RM                             # noqa: E402
from repro.configs import smoke_config as jax_smoke         # noqa: E402
from repro.models.params import init_params as jax_init     # noqa: E402

from repro_torch.configs import smoke_config                # noqa: E402
from repro_torch.models import mamba as M                   # noqa: E402

ARCH = "jamba-v0.1-52b"
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = ["float32", "bfloat16"]


def _setup(dtype):
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype=dtype,
                               param_dtype=dtype)
    cfg = dataclasses.replace(smoke_config(ARCH), dtype=dtype,
                              param_dtype=dtype)
    jp = jax_init(RM.mamba_params(jcfg), 0)
    # the reference inits dt_bias and A_log to constants; random values
    # make the per-channel decays differ, as in a trained model
    rng = np.random.default_rng(7)
    jp = dict(jp, dt_bias=jnp.asarray(rng.normal(size=cfg.mamba_d_inner)
                                      * 0.5 - 1.0, jnp.float32),
              A_log=jnp.asarray(rng.normal(size=(cfg.mamba_d_inner,
                                                 cfg.mamba_d_state)) * 0.5,
                                jnp.float32))
    p = {k: _t(v, v.dtype.name) for k, v in jp.items()}
    return jcfg, cfg, jp, p


def _t(a, dtype):
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _x(shape, dtype, seed, scale=1.0):
    x = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    return _t(x, dtype), jnp.asarray(x).astype(dtype)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_prefill(dtype, chunk):
    """Several chunks (8, 16: the state carried across chunk edges) and
    one chunk holding the whole sequence (64)."""
    jcfg, cfg, jp, p = _setup(dtype)
    xt, xj = _x((2, 64, cfg.d_model), dtype, 1)
    got = M.mamba(p, cfg, xt, chunk=chunk)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _close(got, RM.mamba(jp, jcfg, xj, chunk=chunk), dtype)


def test_mamba_chunk_must_divide_the_sequence():
    _, cfg, _, p = _setup("float32")
    with pytest.raises(AssertionError):
        M.mamba(p, cfg, torch.zeros(1, 24, cfg.d_model), chunk=16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_inputs(dtype):
    """dt, B, C and A, and from them dA and dB·x, equal the reference's
    `_ssm_inputs` (the port forms dA and dB·x a chunk at a time). In bf16
    x_proj's product is rounded to bf16 before it is cast to f32, by
    both, after sums in different orders."""
    jcfg, cfg, jp, p = _setup(dtype)
    ut, uj = _x((2, 16, cfg.mamba_d_inner), dtype, 2)
    dA, dBx, C = RM._ssm_inputs(jp, jcfg, uj)
    dt, B, Ct, A = M._ssm_inputs(p, cfg, ut)
    assert dt.dtype == B.dtype == Ct.dtype == torch.float32
    gA, gBx = M._discretize(dt, B, ut, A)
    for got, want in ((gA, dA), (gBx, dBx), (Ct, C)):
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_with_a_carried_state(dtype):
    """The causal conv from zeros, then the next tokens with the state
    it left: outputs and states equal the reference's, and the two
    calls equal one call over both parts."""
    jcfg, cfg, jp, p = _setup(dtype)
    ut, uj = _x((2, 12, cfg.mamba_d_inner), dtype, 3)
    o1, s1 = M._conv(p, ut[:, :5])
    w1, ws1 = RM._conv(jp, uj[:, :5])
    o2, s2 = M._conv(p, ut[:, 5:], s1)
    w2, ws2 = RM._conv(jp, uj[:, 5:], ws1)
    assert s1.shape == (2, cfg.mamba_d_conv - 1, cfg.mamba_d_inner)
    for got, want in ((o1, w1), (s1, ws1), (o2, w2), (s2, ws2)):
        _close(got, want, dtype)
    whole, _ = M._conv(p, ut)
    assert torch.equal(torch.cat([o1, o2], 1), whole)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_decode_step_by_step(dtype):
    """12 decode steps from a zero state: each step's output and state
    (h f32, conv in the parameter dtype, written in place) equal the
    reference's `mamba_decode` carried the same way."""
    jcfg, cfg, jp, p = _setup(dtype)
    xt, xj = _x((2, 12, cfg.d_model), dtype, 4)
    state = {"h": torch.zeros(2, cfg.mamba_d_inner, cfg.mamba_d_state),
             "conv": torch.zeros(2, cfg.mamba_d_conv - 1, cfg.mamba_d_inner,
                                 dtype=getattr(torch, dtype))}
    h, conv = state["h"], state["conv"]
    jstate = jax_init(RM.mamba_state_specs(jcfg, 2), 0)
    for t in range(12):
        y = M.mamba_decode(p, cfg, xt[:, t:t + 1], state)
        wy, jstate = RM.mamba_decode(jp, jcfg, xj[:, t:t + 1], jstate)
        assert state["h"] is h and state["conv"] is conv
        _close(y, wy, dtype)
        _close(state["h"], jstate["h"], dtype)
        _close(state["conv"], jstate["conv"], dtype)


def test_decode_recurrence_equals_the_chunked_scan():
    """The port's decode, one token at a time, reproduces its own chunked
    prefill (the recurrence of tests/test_archs_smoke.py), in f32 within
    1e-5."""
    _, cfg, _, p = _setup("float32")
    xt, _ = _x((2, 32, cfg.d_model), "float32", 5)
    want = M.mamba(p, cfg, xt, chunk=8)
    state = {"h": torch.zeros(2, cfg.mamba_d_inner, cfg.mamba_d_state),
             "conv": torch.zeros(2, cfg.mamba_d_conv - 1,
                                 cfg.mamba_d_inner)}
    got = torch.cat([M.mamba_decode(p, cfg, xt[:, t:t + 1], state)
                     for t in range(32)], 1)
    _close(got, want.numpy(), "float32")


def test_scan_is_the_sequential_recurrence():
    """`_scan` against the loop h_t = a_t·h_{t-1} + v_t from h = 0, at
    ragged chunk lengths (no power of two)."""
    g = torch.Generator().manual_seed(0)
    for c in (1, 2, 5, 13, 64):
        a = torch.rand(2, c, 3, 4, generator=g)
        v = torch.randn(2, c, 3, 4, generator=g)
        a_cum, v_cum = M._scan(a, v)
        h, ap = torch.zeros(2, 3, 4), torch.ones(2, 3, 4)
        for t in range(c):
            h, ap = a[:, t] * h + v[:, t], ap * a[:, t]
            torch.testing.assert_close(v_cum[:, t], h, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(a_cum[:, t], ap, rtol=1e-5,
                                       atol=1e-7)


def test_state_specs_equal_the_reference():
    jcfg, cfg = jax_smoke(ARCH), smoke_config(ARCH)
    want = RM.mamba_state_specs(jcfg, 3)
    got = M.mamba_state_specs(cfg, 3)
    for key in ("h", "conv"):
        assert got[key].shape == want[key].shape
        assert got[key].axes == want[key].axes
        assert (str(got[key].dtype).replace("torch.", "")
                == np.dtype(want[key].dtype).name)
