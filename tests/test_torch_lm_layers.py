"""The port's LM layers (`repro_torch.models.layers`) against
`repro.models.layers` at smoke sizes, on the same weights (drawn by the
reference, carried across as numpy) and the same seeded inputs: f32
within 1e-5, bf16 within 2e-2 (both frameworks round bf16 at the same
points, but sum in different orders and, in attention, the reference
rounds its logits to bf16 where the port's kernel keeps f32)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from repro.configs import get_config as jax_config         # noqa: E402
from repro.configs import smoke_config as jax_smoke         # noqa: E402
from repro.models import layers as JL                       # noqa: E402
from repro.models.params import init_params as jax_init     # noqa: E402

from repro_torch.configs import smoke_config                # noqa: E402
from repro_torch.models import layers as L                  # noqa: E402

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
DT = {"f32": ("float32", torch.float32, jnp.float32),
      "bf16": ("bfloat16", torch.bfloat16, jnp.bfloat16)}


def _cfgs(arch, dtype):
    name = DT[dtype][0]
    return (dataclasses.replace(jax_smoke(arch), dtype=name, param_dtype=name),
            dataclasses.replace(smoke_config(arch), dtype=name,
                                param_dtype=name))


def _t(a, dtype):
    """A jax or numpy array as a torch tensor of `dtype` (exact: bf16
    values pass through f32)."""
    return torch.tensor(np.asarray(a, np.float32)).to(DT[dtype][1])


def _pair(shape, dtype, seed, scale=1.0):
    x = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    return _t(x, dtype), jnp.asarray(x, DT[dtype][2])


def _params(tree, dtype, seed=0):
    """(torch tree, jax tree) of the reference's init of `tree`."""
    jp = jax_init(tree, seed)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _t(node, dtype)
    return conv(jp), jp


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_both_branches(dtype):
    xt, xj = _pair((2, 5, 64), dtype, 1, scale=3.0)
    st, sj = _pair((64,), dtype, 2)
    got = L.rms_norm(xt, st, 1e-5)
    assert got.dtype == xt.dtype
    _close(got, JL.rms_norm(xj, sj, 1e-5), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm(dtype):
    xt, xj = _pair((3, 7, 32), dtype, 3, scale=2.0)
    st, sj = _pair((32,), dtype, 4)
    bt, bj = _pair((32,), dtype, 5)
    _close(L.layer_norm(xt, st, bt), JL.layer_norm(xj, sj, bj), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_rope(dtype):
    xt, xj = _pair((2, 9, 3, 16), dtype, 6)
    pos = np.arange(100, 109)[None, :]
    _close(L.apply_rope(xt, torch.tensor(pos), 10_000.0),
           JL.apply_rope(xj, jnp.asarray(pos), 10_000.0), dtype)
    np.testing.assert_allclose(L.rope_freqs(16, 1e6).numpy(),
                               np.asarray(JL.rope_freqs(16, 1e6)), rtol=1e-6)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-14b",
                                  "qwen1.5-32b"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_project_qkv(arch, dtype):
    """Plain GQA, q/k norm (qwen3) and qkv bias (qwen1.5)."""
    jcfg, cfg = _cfgs(arch, dtype)
    pt, pj = _params(JL.attention_params(jcfg), dtype)
    if "bq" in pj:                       # zeros at init: make them matter
        for name in ("bq", "bk", "bv"):
            pt[name], pj[name] = _pair(pj[name].shape, dtype, len(name))
    assert set(pt) == set(L.attention_params(cfg))
    xt, xj = _pair((2, 11, cfg.d_model), dtype, 7)
    pos = np.arange(11)[None, :]
    got = L.project_qkv(pt, cfg, xt, torch.tensor(pos))
    want = JL.project_qkv(pj, jcfg, xj, jnp.asarray(pos))
    for g, w in zip(got, want):
        _close(g, w, dtype)


def test_kv_repeat_idx_is_the_kernels_head_map():
    """On the real heads the reference's repeat index is q head // group,
    which is how the attention kernels pick a kv head."""
    for arch in ("tinyllama-1.1b", "granite-3-2b", "qwen3-14b"):
        for jcfg in (jax_smoke(arch), jax_config(arch)):
            group = jcfg.num_heads // jcfg.num_kv_heads
            want = np.asarray(JL._kv_repeat_idx(jcfg))[:jcfg.num_heads]
            cfg = dataclasses.replace(smoke_config(arch), **{
                f: getattr(jcfg, f) for f in ("num_heads", "num_kv_heads",
                                              "head_pad_to")})
            got = L._kv_repeat_idx(cfg).numpy()
            assert np.array_equal(got, want)
            assert np.array_equal(got, np.arange(jcfg.num_heads) // group)


@pytest.mark.parametrize("s,chunk", [(64, 1024), (2048, 1024)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_causal_attention(s, chunk, dtype):
    """s = 2048 > chunk: the reference takes its chunked form, the port
    its one kernel path."""
    jcfg, cfg = _cfgs("tinyllama-1.1b", dtype)
    pt, pj = _params(JL.attention_params(jcfg), dtype, seed=1)
    xt, xj = _pair((1, s, cfg.d_model), dtype, 8)
    pos = np.arange(s)[None, :]
    got = L.causal_attention(pt, cfg, xt, torch.tensor(pos))
    want = JL.causal_attention(pj, jcfg, xj, jnp.asarray(pos), chunk=chunk)
    _close(got, want, dtype)


@pytest.mark.parametrize("index", [0, 5, 31])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_writes_the_cache_in_place(index, dtype):
    jcfg, cfg = _cfgs("tinyllama-1.1b", dtype)
    pt, pj = _params(JL.attention_params(jcfg), dtype, seed=2)
    b, S = 2, 32
    xt, xj = _pair((b, 1, cfg.d_model), dtype, 9)
    shape = (b, S, cfg.num_kv_heads, cfg.head_dim)
    kt, kj = _pair(shape, dtype, 10)
    vt, vj = _pair(shape, dtype, 11)
    ptrs = (kt.data_ptr(), vt.data_ptr())
    y, ck, cv = L.decode_attention(pt, cfg, xt, kt, vt, index)
    yj, ckj, cvj = JL.decode_attention(pj, jcfg, xj, kj, vj,
                                       jnp.asarray(index, jnp.int32))
    assert (ck.data_ptr(), cv.data_ptr()) == ptrs     # the same storage
    _close(y, yj, dtype)
    _close(ck, ckj, dtype)
    _close(cv, cvj, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_and_embedding(dtype):
    jcfg, cfg = _cfgs("tinyllama-1.1b", dtype)
    pt, pj = _params(JL.mlp_params(jcfg), dtype, seed=3)
    xt, xj = _pair((2, 6, cfg.d_model), dtype, 12)
    _close(L.mlp(pt, xt), JL.mlp(pj, xj), dtype)
    et, ej = _params(JL.embed_params(jcfg), dtype, seed=4)
    assert et["embedding"].shape == (cfg.padded_vocab(), cfg.d_model)
    tok = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 6))
    _close(L.embed(et, torch.tensor(tok)), JL.embed(ej, jnp.asarray(tok)),
           dtype)
    _close(L.unembed(et, xt), JL.unembed(ej, xj), dtype)
