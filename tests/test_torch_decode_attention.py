"""The port's decode attention (`kernels/decode_attention`, plain PyTorch
on the CPU) against the JAX package's Pallas `decode_attention` run in
interpret mode, at the shapes and cache indices of tests/test_kernels.py
(2e-4 for f32, 2e-2 for bf16, the reference test's tolerances), and at a
ragged cache length that the Pallas kernel cannot take, against the JAX
`ref.py`; the plain split-and-combine form of the bf16 CUDA kernel against
both; and the host-side split of the cache rows. The CUDA kernel itself is
held against the plain versions on the card by chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from repro.kernels.decode_attention.ops import (            # noqa: E402
    decode_attention as jax_decode)
from repro.kernels.decode_attention.ref import (            # noqa: E402
    decode_attention_ref as jax_decode_ref)

from repro_torch.kernels.decode_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (      # noqa: E402
    decode_attention_ref, decode_attention_split_ref)

TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=2e-2, atol=2e-2)}
DT = {"f32": (torch.float32, jnp.float32),
      "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(b, S, nq, nkv, hd, dtype, seed):
    """q (b, 1, nq, hd) and caches (b, S, nkv, hd) as (torch, jax) pairs
    rounded from the same f32 values."""
    r = np.random.default_rng(seed)
    tdt, jdt = DT[dtype]
    out = []
    for shape in ((b, 1, nq, hd), (b, S, nkv, hd), (b, S, nkv, hd)):
        x = r.normal(size=shape).astype(np.float32)
        out.append((torch.tensor(x).to(tdt), jnp.asarray(x, jdt)))
    return out


@pytest.mark.parametrize("b,S,nq,nkv,hd,idx", [
    (2, 1024, 8, 2, 32, 700), (1, 512, 4, 4, 64, 0),
    (2, 2048, 16, 8, 32, 2047),
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_equals_pallas(b, S, nq, nkv, hd, idx, dtype):
    (qt, qj), (kt, kj), (vt, vj) = _inputs(b, S, nq, nkv, hd, dtype, idx)
    out = ops.decode_attention(qt, kt, vt, idx)
    want = jax_decode(qj, kj, vj, idx, block_s=256, interpret=True)
    assert out.shape == (b, 1, nq, hd) and out.dtype == qt.dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("idx", [0, 300, 999])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ragged_cache_equals_jax_ref(idx, dtype):
    """S = 1000 is no multiple of a block: the port runs it, the Pallas
    kernel asserts; held against the JAX oracle."""
    b, S, nq, nkv, hd = 2, 1000, 8, 2, 16
    (qt, qj), (kt, kj), (vt, vj) = _inputs(b, S, nq, nkv, hd, dtype, idx + 7)
    out = ops.decode_attention(qt, kt, vt, idx)
    want = jax_decode_ref(qj[:, 0].reshape(b, nkv, nq // nkv, hd), kj, vj,
                          idx).reshape(b, 1, nq, hd)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_rows_past_the_index_change_nothing():
    """Whatever the cache holds past cache_index (here large values) adds
    exact zeros: the output is bit for bit the same. The CUDA kernel does
    not read those rows at all."""
    (qt, _), (kt, _), (vt, _) = _inputs(1, 64, 4, 2, 16, "f32", 9)
    clean = ops.decode_attention(qt, kt, vt, 20)
    kt[:, 21:] = 1e4
    vt[:, 21:] = -1e4
    assert torch.equal(ops.decode_attention(qt, kt, vt, 20), clean)


def test_plain_version_equals_jax_oracle():
    r = np.random.default_rng(11)
    q = r.normal(size=(2, 3, 4, 32)).astype(np.float32)
    k, v = (r.normal(size=(2, 80, 3, 32)).astype(np.float32) for _ in "kv")
    out = decode_attention_ref(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), 41)
    want = jax_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 41)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_no_quiet_fallback():
    """The CUDA wrapper takes CUDA tensors only, and the public wrapper
    gives a device it has no kernel for an error, not the CPU version."""
    from torch_stand_in import OtherDevice
    q = torch.zeros(1, 2, 2, 16)
    cache = torch.zeros(1, 32, 2, 16)
    with pytest.raises(ValueError, match="expected a CUDA device"):
        kernel.decode_attention(q, cache, cache, 3)
    other = OtherDevice(1, 32, 2, 16)
    with pytest.raises(ValueError, match="no decode_attention"):
        ops.decode_attention(OtherDevice(1, 1, 4, 16), other, other, 3)
    assert kernel.decode_attention.launches == 0


@pytest.mark.parametrize("pairs", [1, 2, 7, 16, 64, 256, 512, 2048, 5000])
def test_split_plan_covers_every_row_once(pairs):
    """The bf16 kernel's split of n valid rows over (batch row, kv head)
    pairs: every row in exactly one split, no split empty, splits of whole
    tiles, at most MAX_SPLITS of them, and no more blocks than the target
    unless each pair has a single split."""
    for n in list(range(1, 600)) + list(range(600, 33000, 97)):
        splits, rows = kernel.split_plan(n, pairs)
        assert 1 <= splits <= kernel.MAX_SPLITS
        assert rows % kernel.TILE_ROWS == 0
        bounds = [(s * rows, min((s + 1) * rows, n)) for s in range(splits)]
        assert all(lo < hi for lo, hi in bounds), (n, pairs, splits, rows)
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert splits == 1 or pairs * splits <= kernel.TARGET_BLOCKS


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("group", [1, 5, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_split_and_combine_equals_pallas(splits, group, dtype):
    """The plain split-and-combine form of the CUDA kernel (partials
    m, l, acc per run of rows, folded in run order) against the Pallas
    kernel in interpret mode and the JAX oracle."""
    b, S, nkv, hd, idx = 2, 512, 2, 32, 400
    nq = nkv * group
    (qt, qj), (kt, kj), (vt, vj) = _inputs(b, S, nq, nkv, hd, dtype,
                                           splits + 10 * group)
    qg = qt.reshape(b, nkv, group, hd)
    out = decode_attention_split_ref(qg, kt, vt, idx, splits)
    assert out.shape == (b, nkv, group, hd) and out.dtype == qt.dtype
    got = out.float().numpy()
    want = jax_decode(qj, kj, vj, idx, block_s=256, interpret=True)
    np.testing.assert_allclose(got.reshape(b, 1, nq, hd),
                               np.asarray(want, np.float32), **TOL[dtype])
    oracle = jax_decode_ref(qj[:, 0].reshape(b, nkv, group, hd), kj, vj, idx)
    np.testing.assert_allclose(got, np.asarray(oracle, np.float32),
                               **TOL[dtype])


def test_split_ref_refuses_an_empty_run():
    (qt, _), (kt, _), (vt, _) = _inputs(1, 64, 2, 2, 16, "f32", 3)
    with pytest.raises(ValueError, match="empty run"):
        decode_attention_split_ref(qt.reshape(1, 2, 1, 16), kt, vt, 9, 4,
                                   rows=8)


F8 = torch.float8_e4m3fn


def _f8_cache(shape, seed):
    """An f8 e4m3fn cache as a (torch, jax) pair with the same bytes, from
    seeded normals scaled to use e4m3's range."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    j = jnp.asarray(4 * x).astype(jnp.float8_e4m3fn)
    return torch.tensor(np.asarray(j).view(np.uint8)).view(F8), j


@pytest.mark.parametrize("b,S,nq,nkv,hd,idx", [
    (2, 1024, 8, 2, 32, 700), (1, 512, 4, 4, 64, 0),
    (2, 2048, 16, 8, 32, 2047),
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_f8_cache_equals_pallas_on_the_dequantized_cache(b, S, nq, nkv, hd,
                                                         idx, dtype):
    """The plain version on an f8 cache (dequantized to q's dtype, as the
    reference's `kg.astype(q.dtype)`) against the Pallas kernel in
    interpret mode on the cache dequantized in JAX, and bit for bit the
    plain version on the port's own dequantized copy."""
    tdt, jdt = DT[dtype]
    (qt, qj), _, _ = _inputs(b, 1, nq, nkv, hd, dtype, idx + 3)
    (kt, kj), (vt, vj) = (_f8_cache((b, S, nkv, hd), idx + s)
                          for s in (4, 5))
    out = ops.decode_attention(qt, kt, vt, idx)
    assert out.shape == (b, 1, nq, hd) and out.dtype == tdt
    want = jax_decode(qj, kj.astype(jdt), vj.astype(jdt), idx, block_s=256,
                      interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])
    assert torch.equal(out, ops.decode_attention(qt, kt.to(tdt), vt.to(tdt),
                                                 idx))


def test_f8_split_form_equals_the_dequantized_split_form():
    """The plain split-and-combine form (the bf16 CUDA kernel's) on an f8
    cache is bit for bit its form on the dequantized cache."""
    (qt, _), _, _ = _inputs(2, 1, 8, 2, 32, "bf16", 30)
    kt, _ = _f8_cache((2, 600, 2, 32), 31)
    vt, _ = _f8_cache((2, 600, 2, 32), 32)
    qg = qt.reshape(2, 2, 4, 32)
    assert torch.equal(
        decode_attention_split_ref(qg, kt, vt, 555, 3),
        decode_attention_split_ref(qg, kt.to(torch.bfloat16),
                                   vt.to(torch.bfloat16), 555, 3))


@pytest.mark.parametrize("q_dtype,cache_dtype,match", [
    (torch.float16, F8, "f32 or bf16 q"),
    (torch.bfloat16, torch.float8_e5m2, "float8_e4m3fn"),
    (torch.bfloat16, torch.int8, "float8_e4m3fn"),
    (torch.float32, torch.bfloat16, "float8_e4m3fn"),
])
def test_cache_dtypes_the_kernel_does_not_take_raise(q_dtype, cache_dtype,
                                                     match):
    """An f8 cache with a q other than f32 or bf16, another 8-bit cache,
    or a cache of another dtype than q's raises on either device."""
    q = torch.zeros(1, 1, 4, 16, dtype=q_dtype)
    cache = torch.zeros(1, 32, 2, 16).to(cache_dtype)
    with pytest.raises(TypeError, match=match):
        ops.decode_attention(q, cache, cache, 3)
    with pytest.raises(TypeError, match="differ"):
        ops.decode_attention(q, cache, cache.to(torch.float32)
                             if cache_dtype != torch.float32 else
                             cache.to(torch.bfloat16), 3)
