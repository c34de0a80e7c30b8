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
    q = torch.zeros(1, 2, 2, 16)
    cache = torch.zeros(1, 32, 2, 16)
    with pytest.raises(ValueError, match="expected a CUDA device"):
        kernel.decode_attention(q, cache, cache, 3)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no decode_attention"):
        ops.decode_attention(torch.zeros(1, 1, 4, 16, device=meta),
                             cache.to(meta), cache.to(meta), 3)
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
