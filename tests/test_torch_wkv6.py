"""The port's WKV6 recurrence (`kernels/wkv6`, plain PyTorch on the CPU)
against the JAX package: the Pallas `wkv6` run in interpret mode at the
shapes of tests/test_kernels.py (5e-4 for f32, 2e-2 for bf16 inputs, the
reference test's tolerances) and at a ragged length; the model's
`wkv_chunked`, state carried in and out, to 1e-5 of the output's scale
(max |want|: an output element is a sum of up to 64 x 16 terms that
cancel, so its own f32 rounding in two summation orders reaches a few
1e-5 of a value near 0); and the clip-binding
regime where the chunked form departs from the exact recurrence, which the
port must follow (the reference's prefill computes the chunked form). The
CUDA kernel itself is held against the same plain version on the card by
chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from repro.kernels.wkv6.ops import wkv6 as jax_wkv6         # noqa: E402
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked  # noqa: E402

from repro_torch.kernels.wkv6 import kernel, ops            # noqa: E402
from repro_torch.kernels.wkv6.ref import (                  # noqa: E402
    wkv6_chunked_ref, wkv6_ref)
from repro_torch.models.rwkv6 import wkv_chunked            # noqa: E402

TOL = {"f32": dict(rtol=5e-4, atol=5e-4), "bf16": dict(rtol=2e-2, atol=2e-2)}
SCALED = 1e-5              # of max |want|, f32 against the JAX f32 form
DT = {"f32": (torch.float32, jnp.float32),
      "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(b, s, H, K, seed, dtype="f32", decay=2.0):
    """r, k, v, la (b, s, H, K) and u (H, K) as (torch, jax) pairs rounded
    from the same f32 values; per-token log-decay -exp(N(-decay, 0.5))."""
    rng = np.random.default_rng(seed)
    tdt, jdt = DT[dtype]
    xs = [rng.normal(size=(b, s, H, K)).astype(np.float32) for _ in "rkv"]
    xs.append(-np.exp(rng.normal(size=(b, s, H, K)) * 0.5 - decay)
              .astype(np.float32))
    out = [(torch.tensor(x).to(tdt), jnp.asarray(x, jdt)) for x in xs]
    u = rng.normal(size=(H, K)).astype(np.float32)
    return out + [(torch.tensor(u), jnp.asarray(u))]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _close_scaled(got, want):
    """max |got − want| ≤ SCALED · max |want|."""
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= SCALED * float(np.abs(want).max()), err


@pytest.mark.parametrize("b,s,H,K,chunk", [
    (2, 128, 3, 16, 32), (1, 64, 2, 32, 64), (2, 96, 1, 16, 32),
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wkv6_equals_pallas(b, s, H, K, chunk, dtype):
    """tests/test_kernels.py:188-211's shapes, decays and tolerances."""
    (rt, rj), (kt, kj), (vt, vj), (lt, lj), (ut, uj) = _inputs(
        b, s, H, K, s + H, dtype)
    out = ops.wkv6(rt, kt, vt, lt, ut, chunk=chunk)
    want = jax_wkv6(rj, kj, vj, lj, uj, chunk=chunk, interpret=True)
    assert out.shape == (b, s, H, K) and out.dtype == torch.float32
    _close(out, want, TOL[dtype])


def test_ragged_length_equals_reference_wrapper():
    """s = 100 with chunk 32: the reference wrapper pads to 128 with
    zeros, the port masks (pads, on the CPU) the last chunk."""
    (rt, rj), (kt, kj), (vt, vj), (lt, lj), (ut, uj) = _inputs(
        2, 100, 3, 16, 7)
    out = ops.wkv6(rt, kt, vt, lt, ut, chunk=32)
    want = jax_wkv6(rj, kj, vj, lj, uj, chunk=32, interpret=True)
    assert out.shape == (2, 100, 3, 16)
    _close(out, want, TOL["f32"])


@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 64), (48, 64)])
def test_chunked_equals_model_wkv_chunked(s, chunk):
    """The model's chunked form with a nonzero state carried in: the
    output and the state carried out, in f32 to 1e-5 (s = 48 with chunk
    64 is one chunk of 48, as `min(chunk, s)` takes it)."""
    b, H, K = 2, 2, 16
    (rt, rj), (kt, kj), (vt, vj), (lt, lj), (ut, uj) = _inputs(
        b, s, H, K, s, decay=1.0)
    s_in = np.random.default_rng(9).normal(size=(b, H, K, K)).astype(
        np.float32)
    out, s_out = wkv_chunked(rt, kt, vt, lt, ut, torch.tensor(s_in),
                             chunk=chunk)
    want, want_s = jax_wkv_chunked(rj, kj, vj, lj, uj, jnp.asarray(s_in),
                                   chunk=chunk)
    _close_scaled(out, want)
    _close_scaled(s_out, want_s)


def test_clip_binding_follows_the_chunked_form():
    """Per-token log-decay about -1 (the reference's random init): the
    in-chunk cumulative decay passes -40 some 30-40 tokens into each chunk,
    the clip binds, and the chunked form leaves the exact recurrence until
    the next chunk starts. The port
    equals the reference's chunked form and differs from the exact
    recurrence there, as the reference's prefill does."""
    (rt, rj), (kt, kj), (vt, vj), (lt, lj), (ut, uj) = _inputs(
        2, 128, 2, 16, 11, decay=0.0)
    out = ops.wkv6(rt, kt, vt, lt, ut, chunk=64)
    s0 = jnp.zeros((2, 2, 16, 16), jnp.float32)
    want, _ = jax_wkv_chunked(rj, kj, vj, lj, uj, s0, chunk=64)
    _close_scaled(out, want)
    exact = wkv6_ref(*(t.transpose(1, 2) for t in (rt, kt, vt, lt)),
                     ut).transpose(1, 2)
    gap = (out - exact).abs().amax(dim=(0, 2, 3))        # per position
    in_chunk = torch.arange(128) % 64
    assert float(gap[in_chunk < 24].max()) < 1e-4     # clip not binding yet
    assert float(gap[in_chunk >= 40].min()) > 1e-1    # clip binding


def test_oracles_agree():
    """Where the clip does not bind, the chunked form equals the exact
    recurrence, and the port's oracle equals the JAX oracle."""
    (rt, rj), (kt, kj), (vt, vj), (lt, lj), (ut, uj) = _inputs(
        2, 80, 3, 16, 5)
    tr = (lambda t: t.transpose(1, 2))
    exact = wkv6_ref(tr(rt), tr(kt), tr(vt), tr(lt), ut)
    want = jax_wkv6_ref(*(x.transpose(0, 2, 1, 3) for x in (rj, kj, vj, lj)),
                        uj)
    _close_scaled(exact, want)
    out, _ = wkv6_chunked_ref(rt, kt, vt, lt, ut, chunk=32)
    _close(out, np.asarray(want).transpose(0, 2, 1, 3), TOL["f32"])


def test_no_quiet_fallback():
    """The CUDA wrapper takes CUDA tensors only, and the public wrapper
    gives a device it has no kernel for an error, not the CPU version."""
    x = torch.zeros(1, 64, 2, 16)
    u = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="expected a CUDA device"):
        kernel.wkv6(x, x, x, x, u)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no wkv6"):
        ops.wkv6(*(t.to(meta) for t in (x, x, x, x, u)))
    assert kernel.wkv6.launches == 0


# ---------------------------------------------------------------------------
# The CUDA kernel runs its four products on the tensor cores in 3xTF32: each
# f32 operand x is split into hi and lo = x − hi, both TF32, and a product
# is lo·hi′ + hi·lo′ + hi·hi′ accumulated in f32. The emulation below is the
# chunked form with every product so computed (the bonus on att's
# diagonal, as the kernel folds it), held against the JAX f32 form, with hi
# rounded to nearest as `cvt.rna.tf32.f32` does, or truncated as the
# kernel takes it (the tensor core drops an operand's 13 low bits).
# ---------------------------------------------------------------------------

def _tf32(x):
    """Round f32 to TF32 nearest, ties away from zero, as
    `cvt.rna.tf32.f32` does: add half of the 13 dropped mantissa bits to
    the magnitude and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """f32 to TF32 toward zero: the 13 low mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b, hi=_tf32):
    ah, bh = hi(a), hi(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_1xtf32(a, b, hi=_tf32):
    return hi(a) @ hi(b)


def _chunked_emulated(r, k, v, la, u, chunk, mm):
    """The chunked WKV6 form from a zero state, f32 elementwise work, every
    product through `mm`; (b, s, H, K) inputs with s a multiple of the
    chunk. The cumulative decay is the sequential cumsum the kernel takes."""
    b, s, H, K = r.shape
    tr = (lambda t: t.permute(0, 2, 1, 3))          # (b, H, s, K)
    r, k, v, la = (tr(t.float()) for t in (r, k, v, la))
    S = torch.zeros((b, H, K, K))
    lower = torch.ones((chunk, chunk)).tril(-1).bool()
    diag = torch.eye(chunk).bool()
    outs = []
    for c0 in range(0, s, chunk):
        rr, kk, vv, ll = (t[:, :, c0:c0 + chunk] for t in (r, k, v, la))
        a = ll.cumsum(2)
        a_prev = a - ll
        rs = rr * torch.exp(a_prev)
        rf = rr * torch.exp(a_prev.clamp(-40, 40))
        kf = kk * torch.exp((-a).clamp(-40, 40))
        beta = (rr * u[None, :, None] * kk).sum(-1)
        att = mm(rf, kf.transpose(-1, -2))
        att = torch.where(lower, att, torch.zeros(()))
        att = torch.where(diag, beta[..., None], att)
        outs.append(mm(rs, S) + mm(att, vv))
        a_last = a[:, :, -1:]
        kd = kk * torch.exp(a_last - a)
        S = S * torch.exp(a_last.transpose(-1, -2)) + mm(
            kd.transpose(-1, -2), vv)
    return torch.cat(outs, 2).permute(0, 2, 1, 3)


def _rel_norm(got, want):
    want = torch.tensor(np.asarray(want, np.float32))
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
@pytest.mark.parametrize("decay", [2.0, 0.0])
@pytest.mark.parametrize("K", [16, 64])
@pytest.mark.parametrize("chunk", [16, 64])
def test_3xtf32_products_meet_the_card_limit(chunk, K, decay, rounding):
    """3xTF32 in every product stays within ‖got − want‖/‖want‖ ≤ 1e-5 of
    the JAX f32 chunked form (chip_smoke.py's WKV_NORM_TOL), with decays of
    −e^-2 and −e^0 a token (the latter binds the clip, as on rwkv6-3b's
    prefill), hi rounded to nearest or truncated; one TF32 product does
    not, so the limit tells the two apart."""
    hi = _tf32 if rounding == "nearest" else _tf32_trunc
    b, s, H = 2, 128, 2
    (rt, rj), (kt, kj), (vt, vj), (lt, lj), (ut, uj) = _inputs(
        b, s, H, K, chunk + K, decay=decay)
    s0 = jnp.zeros((b, H, K, K), jnp.float32)
    want, _ = jax_wkv_chunked(rj, kj, vj, lj, uj, s0, chunk=chunk)
    three = _rel_norm(_chunked_emulated(
        rt, kt, vt, lt, ut, chunk, lambda a, b: _mm_3xtf32(a, b, hi)), want)
    one = _rel_norm(_chunked_emulated(
        rt, kt, vt, lt, ut, chunk, lambda a, b: _mm_1xtf32(a, b, hi)), want)
    assert three <= 1e-5, three
    assert one > 1e-5, one


def test_tf32_rounding_is_nearest_away():
    """The emulated `cvt.rna.tf32.f32`: 10 mantissa bits kept, a tie
    rounded away from zero for either sign, exact values untouched; and
    truncation toward zero."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one, one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0], dtype=torch.float32)
    want = torch.tensor([one, one + ulp, -(one + ulp), one, one + ulp, 3.0])
    assert torch.equal(_tf32(x), want)
    assert torch.equal(_tf32_trunc(x),
                       torch.tensor([one, one, -one, one, one, 3.0]))
