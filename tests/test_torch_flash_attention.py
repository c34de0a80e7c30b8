"""The port's causal GQA attention (`kernels/flash_attention`, plain
PyTorch on the CPU) against the JAX package's Pallas `flash_attention` run
in interpret mode, at the shapes of tests/test_kernels.py (2e-4 for f32,
2e-2 for bf16, the reference test's tolerances); at a ragged length that
the Pallas wrapper cannot take, against the JAX `ref.py`; and the twin of
`test_flash_matches_model_attention`. The CUDA kernel itself is held
against the same plain version on the card by chip_smoke.py.

The backward: `flash_attention_bwd_ref` (the formulas written out) against
torch.autograd through `flash_attention_ref`, and both, with the
`FlashAttention` autograd function the CPU runs, against `jax.grad` of the
reference's `flash_attention_ref` at head dims 16 to 128, groups 1, 2 and
4 and ragged lengths (f32 within 1e-5, bf16 within 2e-2); the saved
logsumexp against torch.logsumexp of the masked logits; the function's
node on an output that needs a gradient (fault F5's smallest input on the
CPU), and the no-backward guard the decode and WKV6 kernels keep on
CUDA."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.kernels.flash_attention.ops import (             # noqa: E402
    flash_attention as jax_flash)
from repro.kernels.flash_attention.ref import (             # noqa: E402
    flash_attention_ref as jax_flash_ref)

from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.checks import check_no_grad       # noqa: E402
from repro_torch.kernels.flash_attention.ref import (       # noqa: E402
    flash_attention_bwd_ref, flash_attention_fwd_ref, flash_attention_ref)

TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=2e-2, atol=2e-2)}
DT = {"f32": (torch.float32, jnp.float32),
      "bf16": (torch.bfloat16, jnp.bfloat16)}


def _qkv(b, s, nq, nkv, hd, dtype, seed):
    """Model-layout q, k, v as (torch, jax) pairs rounded from the same
    f32 values."""
    r = np.random.default_rng(seed)
    tdt, jdt = DT[dtype]
    out = []
    for h in (nq, nkv, nkv):
        x = r.normal(size=(b, s, h, hd)).astype(np.float32)
        out.append((torch.tensor(x).to(tdt), jnp.asarray(x, jdt)))
    return out


@pytest.mark.parametrize("b,s,nq,nkv,hd,bq", [
    (1, 128, 4, 4, 32, 64),     # MHA
    (2, 256, 8, 2, 32, 128),    # GQA 4:1
    (1, 512, 6, 1, 64, 128),    # MQA-ish, 6 heads
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_equals_pallas(b, s, nq, nkv, hd, bq, dtype):
    (qt, qj), (kt, kj), (vt, vj) = _qkv(b, s, nq, nkv, hd, dtype, s + nq)
    out = ops.flash_attention(qt, kt, vt)
    want = jax_flash(qj, kj, vj, block_q=bq, block_k=bq, interpret=True)
    assert out.shape == (b, s, nq, hd) and out.dtype == qt.dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("s", [200, 1000])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ragged_length_equals_jax_ref(s, dtype):
    """s not a multiple of any block: the port runs it, the Pallas wrapper
    asserts; held against the JAX oracle in its (b, h, s, hd) layout."""
    (qt, qj), (kt, kj), (vt, vj) = _qkv(1, s, 8, 2, 16, dtype, s)
    out = ops.flash_attention(qt, kt, vt)
    want = jax_flash_ref(qj.transpose(0, 2, 1, 3), kj.transpose(0, 2, 1, 3),
                         vj.transpose(0, 2, 1, 3)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("s,nq,nkv,hd", [
    (127, 8, 2, 64),            # one row short of a 128-row q tile
    (128, 8, 2, 64),            # exactly one tile
    (129, 8, 2, 64),            # one row into the second tile
    (129, 10, 2, 128),          # qwen3-14b's head dim and 5:1 grouping
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tile_edges_equal_jax_ref(s, nq, nkv, hd, dtype):
    """The lengths around the CUDA kernel's 128-row tiles, at the head
    dims it runs on the tensor cores, against the JAX oracle."""
    (qt, qj), (kt, kj), (vt, vj) = _qkv(2, s, nq, nkv, hd, dtype, s + hd)
    out = ops.flash_attention(qt, kt, vt)
    want = jax_flash_ref(qj.transpose(0, 2, 1, 3), kj.transpose(0, 2, 1, 3),
                         vj.transpose(0, 2, 1, 3)).transpose(0, 2, 1, 3)
    assert out.shape == (2, s, nq, hd) and out.dtype == qt.dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_plain_version_equals_jax_oracle():
    """Same layout, same f32 math: the two oracles agree to 1e-6."""
    r = np.random.default_rng(3)
    q, k, v = (r.normal(size=(2, h, 96, 32)).astype(np.float32)
               for h in (6, 3, 3))
    out = flash_attention_ref(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v))
    want = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_flash_matches_model_attention():
    """The reference model's chunked attention == the port's attention
    kernel path (plain version here) under the same weights, in f32."""
    from repro.configs import smoke_config
    from repro.models import layers as L
    from repro.models.params import init_params
    cfg = smoke_config("granite-3-2b")
    p = init_params(L.attention_params(cfg), 0)
    r = np.random.default_rng(4)
    x = r.normal(size=(2, 128, cfg.d_model)).astype(np.float32)
    pos = jnp.arange(128)[None, :]
    y_model = L.causal_attention(p, cfg, jnp.asarray(x), pos, chunk=64)
    q, k, v = L.project_qkv(p, cfg, jnp.asarray(x), pos)
    t = {n: torch.tensor(np.asarray(a, np.float32)) for n, a in
         (("q", q), ("k", k), ("v", v), ("wo", L._pad_wo(p["wo"],
                                                          cfg.padded_heads)))}
    out = ops.flash_attention(t["q"], t["k"], t["v"])
    y_kernel = torch.einsum("bshk,hkd->bsd", out, t["wo"])
    np.testing.assert_allclose(y_kernel.numpy(), np.asarray(y_model,
                                                            np.float32),
                               rtol=1e-5, atol=1e-5)


def test_no_quiet_fallback():
    """The CUDA wrapper takes CUDA tensors only, and the public wrapper
    gives a device it has no kernel for an error, not the CPU version."""
    q = torch.zeros(1, 64, 4, 16)
    k = torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError, match="expected a CUDA device"):
        kernel.flash_attention(q, k, k)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no flash_attention"):
        ops.flash_attention(q.to(meta), k.to(meta), k.to(meta))
    assert kernel.flash_attention.launches == 0


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

GRAD_TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
            "bf16": dict(rtol=2e-2, atol=2e-2)}


def _heads_first(*xs):
    return [x.transpose(1, 2) for x in xs]


def _upstream(b, s, nq, hd, dtype, seed):
    x = np.random.default_rng(seed).normal(size=(b, s, nq, hd))
    x = x.astype(np.float32)
    return torch.tensor(x).to(DT[dtype][0]), jnp.asarray(x, DT[dtype][1])


def _jax_grads(qj, kj, vj, doj):
    """jax.vjp of the reference's oracle, in the model layout."""
    def f(q, k, v):
        out = jax_flash_ref(*(x.transpose(0, 2, 1, 3) for x in (q, k, v)))
        return out.transpose(0, 2, 1, 3)
    _, vjp = jax.vjp(f, qj, kj, vj)
    return [np.asarray(g, np.float32) for g in vjp(doj)]


@pytest.mark.parametrize("s,nq,nkv,hd", [
    (37, 2, 2, 16), (70, 4, 2, 32), (129, 8, 2, 64), (50, 4, 1, 128),
    (1, 4, 2, 64)])
def test_bwd_ref_equals_autograd(s, nq, nkv, hd):
    """The written-out backward == autograd through the plain forward, f32
    (at s = 1 the q and k gradients are zero: P = 1, so dS = dP − D = 0)."""
    (qt, _), (kt, _), (vt, _) = _qkv(2, s, nq, nkv, hd, "f32", s + hd)
    do, _ = _upstream(2, s, nq, hd, "f32", s)
    q, k, v = (x.transpose(1, 2).requires_grad_() for x in (qt, kt, vt))
    out = flash_attention_ref(q, k, v)
    want = torch.autograd.grad(out, (q, k, v), do.transpose(1, 2))
    o, lse = flash_attention_fwd_ref(q.detach(), k.detach(), v.detach())
    np.testing.assert_allclose(o.numpy(), out.detach().numpy(), rtol=1e-6,
                               atol=1e-6)
    got = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o,
                                  lse, do.transpose(1, 2))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL["f32"])


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bwd_equals_jax_grad(hd, group, dtype):
    """jax.grad of the reference's oracle == the written-out backward ==
    the `FlashAttention` function's backward, at a ragged length."""
    b, s, nkv = 2, 45 + hd // 16, 2
    nq = nkv * group
    (qt, qj), (kt, kj), (vt, vj) = _qkv(b, s, nq, nkv, hd, dtype, hd + group)
    dot, doj = _upstream(b, s, nq, hd, dtype, hd * group)
    want = _jax_grads(qj, kj, vj, doj)

    o, lse = flash_attention_fwd_ref(*_heads_first(qt, kt, vt))
    plain = [g.transpose(1, 2) for g in flash_attention_bwd_ref(
        *_heads_first(qt, kt, vt), o, lse, dot.transpose(1, 2))]
    q, k, v = (x.clone().requires_grad_() for x in (qt, kt, vt))
    out = ops.flash_attention(q, k, v)
    fn = torch.autograd.grad(out, (q, k, v), dot)
    for name, w, p, f in zip("qkv", want, plain, fn):
        assert p.dtype == f.dtype == qt.dtype, name
        assert p.shape == f.shape == w.shape, name
        np.testing.assert_allclose(p.float().numpy(), w, **GRAD_TOL[dtype],
                                   err_msg=f"d{name} plain")
        np.testing.assert_allclose(f.float().numpy(), w, **GRAD_TOL[dtype],
                                   err_msg=f"d{name} FlashAttention")


@pytest.mark.parametrize("s,nq,nkv,hd", [(1, 2, 1, 16), (77, 4, 2, 32),
                                         (130, 8, 2, 64)])
def test_lse_equals_logsumexp(s, nq, nkv, hd):
    """The saved logsumexp == torch.logsumexp of the scaled logits with
    every column past the diagonal at −1e30."""
    (qt, _), (kt, _), _ = _qkv(1, s, nq, nkv, hd, "f32", s)
    _, lse = flash_attention_fwd_ref(*_heads_first(qt, kt, kt))
    q, k = qt.transpose(1, 2), kt.transpose(1, 2)
    k = k.repeat_interleave(nq // nkv, dim=1)
    logits = q @ k.transpose(-1, -2) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    want = torch.logsumexp(torch.where(causal, logits, -1e30), dim=-1)
    assert lse.shape == (1, nq, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_function_node_on_cpu():
    """F5's smallest input, moved to the CPU: an output that needs a
    gradient hangs off the `FlashAttention` node (on the card the kernel's
    output had none); without one, or under no_grad, there is no node."""
    r = np.random.default_rng(5)
    q, k, v = (torch.tensor(r.normal(size=(1, 16, 2, 64)),
                            dtype=torch.float32) for _ in range(3))
    assert ops.flash_attention(q, k, v).grad_fn is None
    q.requires_grad_()
    out = ops.flash_attention(q, k, v)
    assert isinstance(out.grad_fn, ops.FlashAttention._backward_cls)
    (dq,) = torch.autograd.grad(out.square().sum(), (q,))
    assert dq.shape == q.shape and bool(dq.abs().sum() > 0)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None


def test_no_backward_guard():
    """The decode and WKV6 kernels have no backward: their CUDA paths raise
    under autograd on an input that requires grad (the guard they call),
    and never under no_grad or on inputs that need none."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward kernel"):
        check_no_grad("decode_attention", torch.zeros(2), x)
    with torch.no_grad():
        check_no_grad("wkv6", x)
    check_no_grad("wkv6", torch.zeros(2), torch.zeros(3))
