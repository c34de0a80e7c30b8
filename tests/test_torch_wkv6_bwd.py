"""The backward of the port's WKV6 recurrence on the CPU against
`jax.grad` of the JAX package's chunked form.

The reference never trains through its Pallas `wkv6`: `time_mix`
differentiates the plain `wkv_chunked` (`repro/models/rwkv6.py:127`, the
±40 exponent clip at :151-152). So `wkv6_chunked_bwd_ref` (the written-out
reverse pass, also the CPU half of the `WKV6` autograd function; the card
runs the hand-written `wkv6_bwd` kernel, held to it by chip_smoke.py) is
held to `jax.grad` of `wkv_chunked` behind the padding that the
reference's wrapper (`repro/kernels/wkv6/ops.py`) puts around a ragged
length: chunk edges, a ragged s, s below the chunk, decays at which the
clip binds, and planted exponents of exactly ±40, where `jax.grad` of
`jnp.clip` gives 1/2 (a max and a min, each splitting a tie).

Limits, f32: |got − want| ≤ 1e-4·|want| + 1e-5·max |want| elementwise and
‖got − want‖ ≤ 1e-5·‖want‖. The absolute part is scaled by the output, as
tests/test_torch_wkv6.py scales its forward: an element is a sum of up to
64 x 64 terms of the output's size that cancel, and its f32 rounding in
two summation orders reaches a few 1e-6 of max |want| (measured up to
3.8e-6)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked  # noqa: E402

from repro_torch.kernels.checks import check_no_grad        # noqa: E402
from repro_torch.kernels.wkv6 import ops                    # noqa: E402
from repro_torch.kernels.wkv6.ref import (                  # noqa: E402
    CLIP, clip_grad, wkv6_chunked_bwd_ref, wkv6_chunked_ref)

RTOL, SCALED, NORM = 1e-4, 1e-5, 1e-5
NAMES = ("dr", "dk", "dv", "dla", "du")


def _inputs(b, s, H, K, seed, decay):
    """f32 numpy r, k, v, la, u and the upstream gradient do; per-token
    log-decay -exp(N(-decay, 0.5))."""
    rng = np.random.default_rng(seed)
    shape = (b, s, H, K)
    r, k, v = (rng.normal(size=shape).astype(np.float32) for _ in "rkv")
    la = (-np.exp(rng.normal(size=shape) * 0.5 - decay)).astype(np.float32)
    u = rng.normal(size=(H, K)).astype(np.float32)
    do = rng.normal(size=shape).astype(np.float32)
    return r, k, v, la, u, do


def _jax_grads(r, k, v, la, u, do, chunk):
    """jax.grad of Σ do ⊙ out, out the reference's `wkv_chunked` from a
    zero state behind the reference wrapper's padding (c = min(chunk, s),
    s padded with zero rows to a multiple of c, the output cut back)."""
    b, s, H, K = r.shape
    c = min(chunk, s)
    pad = (-s) % c

    def loss(r, k, v, la, u):
        p = [jnp.pad(t, ((0, 0), (0, pad), (0, 0), (0, 0)))
             for t in (r, k, v, la)]
        out, _ = jax_wkv_chunked(*p, u, jnp.zeros((b, H, K, K), jnp.float32),
                                 chunk=c)
        return (out[:, :s] * jnp.asarray(do)).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(x) for x in (r, k, v, la, u)))
    return [np.asarray(g, np.float32) for g in grads]


def _close(got, want, name):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=SCALED * scale,
                               err_msg=name)
    assert (np.linalg.norm(got - want)
            <= NORM * np.linalg.norm(want)), name


def _binds(la, chunk):
    """Whether the exponent clip binds somewhere: a cumulative in-chunk
    log-decay below −40."""
    s = la.shape[1]
    c = min(chunk, s)
    return any(np.cumsum(la[:, c0:c0 + c], axis=1).min() < -CLIP
               for c0 in range(0, s, c))


@pytest.mark.parametrize("b,s,H,K,chunk,decay,binds", [
    (2, 64, 2, 16, 16, 2.0, False),     # whole chunks, exact regime
    (2, 100, 3, 16, 32, 1.0, False),    # ragged last chunk
    (1, 37, 2, 32, 64, 0.0, True),      # s below the chunk: one of 37
    (2, 130, 2, 16, 64, -1.0, True),    # the clip binds in every chunk
    (1, 96, 2, 64, 32, 0.0, True),      # rwkv6-3b's head size
])
def test_bwd_ref_equals_jax_grad(b, s, H, K, chunk, decay, binds):
    r, k, v, la, u, do = _inputs(b, s, H, K, s + K, decay)
    assert _binds(la, chunk) == binds
    want = _jax_grads(r, k, v, la, u, do, chunk)
    got = wkv6_chunked_bwd_ref(*(torch.tensor(x)
                                 for x in (r, k, v, la, u, do)), chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        _close(g, w, name)


def _planted(s=20, H=2, K=16):
    """Exponents of exactly −40 and +40: la = −20, −20, 0, ... so that
    a = −40 from row 1 (−a = 40 in k_f's clip) and a_prev = −40 from row 2
    (r_f's clip), both ties of jnp.clip."""
    r, k, v, la, u, do = _inputs(1, s, H, K, 7, 1.0)
    la[:, :] = 0.0
    la[:, 0] = la[:, 1] = -20.0
    return r, k, v, la, u, do


def test_clip_derivative_is_half_at_the_bound():
    """jax.grad of jnp.clip is 1/2 at exactly ±40; torch.clamp's backward
    gives 1. The written-out backward follows jax (elementwise and in
    norm), and autograd through the clamp of `wkv6_chunked_ref` does
    not, so the planted case tells the two apart."""
    x = torch.tensor([-41.0, -CLIP, -39.0, 0.0, 39.0, CLIP, 41.0])
    assert clip_grad(x).tolist() == [0.0, 0.5, 1.0, 1.0, 1.0, 0.5, 0.0]
    jx = jax.grad(lambda t: jnp.clip(t, -CLIP, CLIP).sum())(
        jnp.asarray(x.numpy()))
    assert np.asarray(jx).tolist() == clip_grad(x).tolist()

    r, k, v, la, u, do = _planted()
    want = _jax_grads(r, k, v, la, u, do, 32)
    ts = [torch.tensor(a) for a in (r, k, v, la, u, do)]
    got = wkv6_chunked_bwd_ref(*ts, 32)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)
    xs = [t.clone().requires_grad_() for t in ts[:5]]
    clamp = torch.autograd.grad(wkv6_chunked_ref(*xs, 32)[0], xs, ts[5])
    dla_clamp, dla_want = clamp[3].numpy(), want[3]
    off = np.abs(dla_clamp - dla_want) > (
        RTOL * np.abs(dla_want) + SCALED * np.abs(dla_want).max())
    assert off.any()                    # torch.clamp's 1 at the bound shows


@pytest.mark.parametrize("chunk", [16, 64])
def test_wkv6_function_on_cpu(chunk):
    """Under autograd `ops.wkv6` is the `WKV6` node and its gradients are
    `wkv6_chunked_bwd_ref`'s (the CPU half of the function), bf16 inputs
    included (their gradients cast back); without an input that requires
    grad, or under no_grad, there is no node."""
    r, k, v, la, u, do = _inputs(2, 50, 2, 16, chunk, 1.0)
    ts = [torch.tensor(a) for a in (r, k, v, la, u)]
    dot = torch.tensor(do)
    assert ops.wkv6(*ts, chunk=chunk).grad_fn is None
    xs = [t.clone().requires_grad_() for t in ts]
    out = ops.wkv6(*xs, chunk=chunk)
    assert isinstance(out.grad_fn, ops.WKV6._backward_cls)
    torch.testing.assert_close(out.detach(),
                               wkv6_chunked_ref(*ts, chunk)[0], rtol=0,
                               atol=0)
    grads = torch.autograd.grad(out, xs, dot)
    want = wkv6_chunked_bwd_ref(*ts, dot, chunk)
    for name, g, w in zip(NAMES, grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
    with torch.no_grad():
        assert ops.wkv6(*xs, chunk=chunk).grad_fn is None
    xb = [t.to(torch.bfloat16).requires_grad_() for t in ts[:4]] + [xs[4]]
    grads = torch.autograd.grad(ops.wkv6(*xb, chunk=chunk), xb, dot)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 4 + [torch.float32]


def test_only_decode_attention_lacks_a_backward():
    """The guard stays on `decode_attention` (serving only): it raises
    under autograd on an input that requires grad. `wkv6` under autograd
    builds its node instead of calling the guard."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="decode_attention has no "
                                           "backward kernel"):
        check_no_grad("decode_attention", torch.zeros(2), x)
    src = open(ops.__file__).read()
    assert "check_no_grad" not in src
