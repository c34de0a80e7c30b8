"""The port's causal GQA attention (`kernels/flash_attention`, plain
PyTorch on the CPU) against the JAX package's Pallas `flash_attention` run
in interpret mode, at the shapes of tests/test_kernels.py (2e-4 for f32,
2e-2 for bf16, the reference test's tolerances); at a ragged length that
the Pallas wrapper cannot take, against the JAX `ref.py`; and the twin of
`test_flash_matches_model_attention`. The CUDA kernel itself is held
against the same plain version on the card by chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from repro.kernels.flash_attention.ops import (             # noqa: E402
    flash_attention as jax_flash)
from repro.kernels.flash_attention.ref import (             # noqa: E402
    flash_attention_ref as jax_flash_ref)

from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (       # noqa: E402
    flash_attention_ref)

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
