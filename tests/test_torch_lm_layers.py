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


# ---------------------------------------------------------------------------
# The audio family's layers (whisper) and the f8 KV cache (qwen1.5-32b)
# ---------------------------------------------------------------------------

from repro.models import transformer as JT                 # noqa: E402

from repro_torch.models import transformer as T            # noqa: E402

F8 = torch.float8_e4m3fn


def _whisper(dtype):
    """whisper-tiny's smoke twin (MHA, 4 heads of 16) in `dtype`."""
    return _cfgs("whisper-tiny", dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_attention_and_encode_kv(dtype):
    """The cross projections carry no bias or norm; `encode_kv` of an
    encoder output, then the decoder's cross-attention over it (every key
    visible, the plain `sdpa`)."""
    jcfg, cfg = _whisper(dtype)
    assert set(L.attention_params(cfg, cross=True)) == set(
        JL.attention_params(jcfg, cross=True)) == {"wq", "wk", "wv", "wo"}
    pt, pj = _params(JL.attention_params(jcfg, cross=True), dtype, seed=5)
    et, ej = _pair((2, 16, cfg.d_model), dtype, 14)
    kv_t, kv_j = L.encode_kv(pt, cfg, et), JL.encode_kv(pj, jcfg, ej)
    for g, w in zip(kv_t, kv_j):
        _close(g, w, dtype)
    xt, xj = _pair((2, 5, cfg.d_model), dtype, 15)
    _close(L.cross_attention(pt, cfg, xt, kv_t),
           JL.cross_attention(pj, jcfg, xj, kv_j), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_decode_attention_equals_cross_attention(dtype):
    """Decode-time cross-attention (one query over every row of the cross
    cache, through `decode_attention` at cache_index = enc_len − 1)
    equals the reference's `cross_attention` on the same query."""
    jcfg, cfg = _whisper(dtype)
    pt, pj = _params(JL.attention_params(jcfg, cross=True), dtype, seed=6)
    et, ej = _pair((2, 16, cfg.d_model), dtype, 16)
    kt, vt = L.encode_kv(pt, cfg, et)
    xt, xj = _pair((2, 1, cfg.d_model), dtype, 17)
    _close(L.cross_decode_attention(pt, cfg, xt, kt, vt),
           JL.cross_attention(pj, jcfg, xj, JL.encode_kv(pj, jcfg, ej)),
           dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bidir_attention(dtype):
    """The whisper encoder's self-attention: no RoPE, no mask."""
    jcfg, cfg = _whisper(dtype)
    pt, pj = _params(JL.attention_params(jcfg), dtype, seed=7)
    xt, xj = _pair((2, 16, cfg.d_model), dtype, 18)
    _close(L.bidir_attention(pt, cfg, xt),
           JT._bidir_attention(pj, jcfg, xj), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ungated_gelu_mlp(dtype):
    """Whisper's MLP: no gate, `jax.nn.gelu`'s tanh form (torch's default
    erf form is 1e-3 away on these inputs and fails the f32 limit)."""
    jcfg, cfg = _whisper(dtype)
    spec = JL.mlp_params(jcfg, gated=False)
    assert set(L.mlp_params(cfg, gated=False)) == set(spec) == {
        "w_in", "w_out"}
    pt, pj = _params(spec, dtype, seed=8)
    xt, xj = _pair((2, 6, cfg.d_model), dtype, 19, scale=3.0)
    import jax
    _close(L.mlp(pt, xt, act=L.gelu), JL.mlp(pj, xj, act=jax.nn.gelu),
           dtype)
    if dtype == "f32":
        erf = L.mlp(pt, xt, act=torch.nn.functional.gelu)
        assert not np.allclose(erf.numpy(), np.asarray(
            JL.mlp(pj, xj, act=jax.nn.gelu)), **TOL["f32"])


# sin and cos of XLA and of torch are each within about an ulp of the
# true value, so on the same f32 angles (the port takes XLA's correctly
# rounded pow) they differ by up to two ulps of a value ≤ 1: 2^-23 in
# f32; such a difference can cross a bf16 rounding boundary, so in bf16
# one ulp of a value < 1: 2^-8
SIN_ATOL = {"f32": 2.0 ** -23, "bf16": 2.0 ** -8}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sinusoidal_positions(dtype):
    """`_sinusoidal` (the whole table to 4,096) and `_sinusoidal_at` at
    indices 0, 1, 1,499 and 4,095, f32 then cast, as the reference forms
    them; within SIN_ATOL (the angles themselves are equal)."""
    name, tdt, jdt = DT[dtype]
    d = 384                                     # whisper-tiny's width
    pe = T._sinusoidal(4096, d, tdt)
    want = np.asarray(JT._sinusoidal(4096, d, jdt), np.float32)
    assert pe.shape == (4096, d) and pe.dtype == tdt
    tol = dict(rtol=0, atol=SIN_ATOL[dtype])
    for i in (0, 1, 1499, 4095):
        at = T._sinusoidal_at(i, d, tdt)
        want_at = np.asarray(JT._sinusoidal_at(jnp.asarray(i, jnp.int32),
                                               d, jdt), np.float32)
        assert torch.equal(at, pe[i])
        np.testing.assert_allclose(at.float().numpy(), want_at, **tol)
    np.testing.assert_allclose(pe.float().numpy(), want, **tol)
    pos = torch.arange(4096.0)
    angles = np.asarray(jnp.arange(4096, dtype=jnp.float32)[:, None] / (
        10000.0 ** (jnp.arange(0, d, 2, dtype=jnp.float32)[None] / d)))
    assert np.array_equal(T._sinusoidal_angles(pos, d).numpy(), angles)


# (value, e4m3fn byte XLA gives it): the largest finite, the 464 tie
# (to 448, even), just past it, ±inf, large values, subnormals and their
# ties (2^-10 to 0, 3·2^-10 to 2^-8: nearest even), NaN of either sign
F8_EDGES = [(0.0, 0x00), (-0.0, 0x80), (448.0, 0x7E), (-448.0, 0xFE),
            (456.0, 0x7E), (464.0, 0x7E), (-464.0, 0xFE), (464.1, 0x7F),
            (465.0, 0x7F), (-465.0, 0xFF), (480.0, 0x7F), (1e6, 0x7F),
            (-1e6, 0xFF), (np.inf, 0x7F), (-np.inf, 0xFF),
            (2.0 ** -10, 0x00), (3 * 2.0 ** -10, 0x02),
            (-3 * 2.0 ** -10, 0x82), (2.0 ** -9, 0x01), (2.0 ** -6, 0x08),
            (1.0625, 0x38), (1.1875, 0x3A), (np.nan, 0x7F),
            (-np.nan, 0xFF)]


def _f8_inputs(x, jdt):
    """f32 values as (torch, jax) arrays of `jdt` with the same bits (a
    NaN keeps its sign: torch's own f32 -> bf16 cast sets it)."""
    xj = jnp.asarray(x).astype(jdt)
    a = np.asarray(xj)
    if jdt == jnp.bfloat16:
        return torch.tensor(a.view(np.int16)).view(torch.bfloat16), xj
    return torch.tensor(a), xj


def _xla_f8_bytes(xj):
    return np.asarray(xj.astype(jnp.float8_e4m3fn)).view(np.uint8)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_f8_cast_edges_equal_xla(dtype):
    """`to_cache_dtype` gives XLA's bytes on the planted edge values (from
    f32 and from bf16), where torch's own cast saturates to ±448."""
    _, tdt, jdt = DT[dtype]
    x = np.array([v for v, _ in F8_EDGES], np.float32)
    xt, xj = _f8_inputs(x, jdt)
    want = _xla_f8_bytes(xj)
    got = L.to_cache_dtype(xt, "float8_e4m3fn")
    assert got.dtype == F8
    assert np.array_equal(got.view(torch.uint8).numpy(), want)
    if dtype == "f32":                          # the table above is XLA's
        assert want.tolist() == [b for _, b in F8_EDGES]
    saturated = xt.to(F8).view(torch.uint8).numpy()
    assert not np.array_equal(saturated, want)  # why the function exists


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_f8_cast_equals_xla_on_seeded_values(dtype):
    """10^5 seeded values over e4m3's whole range and past it (log-uniform
    magnitudes 2^-14 .. 2^10, both signs), byte for byte; other cache
    dtypes are a plain cast."""
    _, tdt, jdt = DT[dtype]
    r = np.random.default_rng(25)
    x = (np.sign(r.normal(size=100_000))
         * 2.0 ** r.uniform(-14, 10, 100_000)).astype(np.float32)
    xt, xj = _f8_inputs(x, jdt)
    got = L.to_cache_dtype(xt, F8)
    assert np.array_equal(got.view(torch.uint8).numpy(), _xla_f8_bytes(xj))
    t = torch.tensor(x[:10])
    assert torch.equal(L.to_cache_dtype(t, "bfloat16"), t.to(torch.bfloat16))


@pytest.mark.parametrize("index", [0, 5, 31])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_writes_an_f8_cache_in_place(index, dtype):
    """qwen1.5-32b's twin (qkv bias, an f8 e4m3fn cache): the new k/v
    written in place with XLA's bytes, the output within the dtype's
    limit of the reference's (which dequantizes the cache to q's dtype)."""
    jcfg, cfg = _cfgs("qwen1.5-32b", dtype)
    assert cfg.cache_dtype == "float8_e4m3fn"
    pt, pj = _params(JL.attention_params(jcfg), dtype, seed=9)
    for name in ("bq", "bk", "bv"):
        pt[name], pj[name] = _pair(pj[name].shape, dtype, len(name) + 20)
    b, S = 2, 32
    xt, xj = _pair((b, 1, cfg.d_model), dtype, 20, scale=4.0)
    shape = (b, S, cfg.num_kv_heads, cfg.head_dim)
    caches = []
    for seed in (21, 22):
        x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
        j = jnp.asarray(x).astype(jnp.float8_e4m3fn)
        caches.append((torch.tensor(np.asarray(j).view(np.uint8)).view(F8),
                       j))
    (kt, kj), (vt, vj) = caches
    ptrs = (kt.data_ptr(), vt.data_ptr())
    y, ck, cv = L.decode_attention(pt, cfg, xt, kt, vt, index)
    yj, ckj, cvj = JL.decode_attention(pj, jcfg, xj, kj, vj,
                                       jnp.asarray(index, jnp.int32))
    assert (ck.data_ptr(), cv.data_ptr()) == ptrs
    assert ck.dtype == cv.dtype == F8
    for got, want in ((ck, ckj), (cv, cvj)):
        assert np.array_equal(got.view(torch.uint8).numpy(),
                              np.asarray(want).view(np.uint8))
    _close(y, yj, dtype)
