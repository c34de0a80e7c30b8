"""The port's LM serving path against the reference on the smoke twins
of tinyllama-1.1b, granite-3-2b, qwen3-14b and qwen1.5-32b (dense; qwen1.5
with qkv bias and an f8 e4m3fn KV cache), pixtral-12b (vlm: image
embeddings in front of the text), whisper-tiny (audio: encoder, decoder,
cross-attention), llama4-scout-17b-a16e (moe, top-1 with a shared expert;
also with padded q heads), dbrx-132b (moe, top-2) and jamba-v0.1-52b
(hybrid: attention, mamba, dense and MoE FFNs), in f32 and in bf16: the
reference's `init_train_state` params are carried across
(`core/convert.py`), then `forward` (with the experts' aux loss; with
`frames` or `img_embeds` where the family takes them), the prefill step,
greedy decode from a zero cache, a decode cache carried across
mid-stream (k/v, the mamba state, whisper's self and cross caches; the
f8 cache bytes equal after every f32 step), whisper's decode against a
cross cache filled from `encode_kv`, and `serve_decode(...,
device="cpu")`. f32: logits within 1e-5, caches within 1e-5, tokens
equal. bf16: logits and caches within 2e-2, the reference test's bf16
tolerance (the two frameworks sum in different orders, and the
reference rounds attention logits to bf16 where the port's kernels keep
f32), tokens equal on the reference's own tokens fed to both (teacher
forcing); qwen3-14b, qwen1.5-32b and the moe and hybrid twins in bf16 by
the noise rule (`NOISY`). Then, without allocating, every registered
config (full size and smoke twin) has the reference's parameter and
cache specs, and `attn_logit_softcap` changes nothing in either
package."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.configs import get_config as jax_config         # noqa: E402
from repro.configs import smoke_config as jax_smoke         # noqa: E402
from repro.models import build as jax_build                 # noqa: E402
from repro.models import steps as JS                        # noqa: E402

from repro_torch.configs import get_config, smoke_config    # noqa: E402
from repro_torch.core.convert import (cache_from_reference,  # noqa: E402
                                      params_from_reference)
from repro_torch.launch import serve                        # noqa: E402
from repro_torch.models import build                        # noqa: E402
from repro_torch.models import steps as S                   # noqa: E402
from repro_torch.models.params import DTYPES                # noqa: E402

ARCH = "tinyllama-1.1b"
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
B, PROMPT, CACHE = 2, 48, 16
# the twins the recipe runs: (arch, dtype, config changes); tinyllama's
# ids are the dtypes alone. "llama4-scout-padded" keeps `head_pad_to`: 6
# q heads over 2 kv heads, which the reference pads to 8
TWINS = {
    "float32": (ARCH, "float32", {}),
    "bfloat16": (ARCH, "bfloat16", {}),
    **{f"{arch}-{dtype}": (arch, dtype, {})
       for arch in ("granite-3-2b", "qwen3-14b", "llama4-scout-17b-a16e",
                    "dbrx-132b", "jamba-v0.1-52b", "whisper-tiny",
                    "pixtral-12b", "qwen1.5-32b")
       for dtype in ("float32", "bfloat16")},
    "llama4-scout-padded-float32": (
        "llama4-scout-17b-a16e", "float32",
        dict(num_heads=6, num_kv_heads=2, head_pad_to=8)),
}
LEAVES = {ARCH: 12, "granite-3-2b": 12, "qwen3-14b": 14,
          "llama4-scout-17b-a16e": 16, "dbrx-132b": 13,
          "jamba-v0.1-52b": 56, "whisper-tiny": 32, "pixtral-12b": 12,
          "qwen1.5-32b": 15}
# these bf16 twins are held by the noise rule: their bf16 noise passes
# 2e-2 in some logits between the two packages as it does between the
# reference's own bf16 and f32 runs (`test_bf16_noise_premise`: a route
# flips at a near tie of two experts' probabilities, jamba's mamba chain
# drifts, qwen3-14b's q/k norms round to bf16, qwen1.5-32b's k and v a
# bf16 ulp apart land on neighbouring e4m3 values of its f8 cache, 12.5%
# apart, in decode). So the port's bf16 must lie as close to the
# reference's f32 result on the same weights as the reference's bf16
# does, within a factor NOISE_RATIO; a wrong rounding point (a state or
# router kept in bf16) multiplies the distance instead.
NOISY = ("qwen3-14b", "llama4-scout-17b-a16e", "dbrx-132b",
         "jamba-v0.1-52b", "qwen1.5-32b")
NOISE_RATIO = 1.5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def _flat(xs):
    if isinstance(xs, dict):
        xs = jax.tree_util.tree_leaves(xs)
    if not isinstance(xs, (list, tuple)):
        xs = [xs]
    return np.concatenate([
        (x.float().numpy() if isinstance(x, torch.Tensor)
         else np.asarray(x, np.float32)).reshape(-1) for x in xs])


def _agree(lm, got, want, want32=None):
    """`got` (the port's: a tensor, a list of them or a cache tree) held
    to `want` (the reference's, alike): within TOL elementwise, or for a
    noisy twin by the noise rule against `want32`, the reference's f32
    result."""
    if "jm32" not in lm:
        if isinstance(got, dict):
            for (path, w), g in zip(
                    jax.tree_util.tree_flatten_with_path(want)[0],
                    jax.tree_util.tree_leaves(got)):
                _close(g, w, lm["dtype"])
            return
        np.testing.assert_allclose(_flat(got), _flat(want),
                                   **TOL[lm["dtype"]])
        return
    g, w, a = _flat(got), _flat(want), _flat(want32)
    assert np.isfinite(g).all()
    ratio = np.linalg.norm(g - a) / np.linalg.norm(w - a)
    assert ratio <= NOISE_RATIO, ratio


_SETUPS = {}


def _setup(key):
    """The reference model and params of a twin (`TWINS[key]`), the
    port's model with the params carried across, and for a noisy bf16
    twin the reference's f32 model on the same weights (made once)."""
    if key not in _SETUPS:
        arch, dtype, over = TWINS[key]
        jcfg = dataclasses.replace(jax_smoke(arch), dtype=dtype,
                                   param_dtype=dtype, **over)
        cfg = dataclasses.replace(smoke_config(arch), dtype=dtype,
                                  param_dtype=dtype, **over)
        jm, m = jax_build(jcfg), build(cfg)
        jp = JS.init_train_state(jm, 0)["params"]
        lm = dict(key=key, arch=arch, dtype=dtype, jcfg=jcfg, cfg=cfg,
                  jm=jm, m=m, jp=jp,
                  p=params_from_reference(_np(jp), cfg, device="cpu"),
                  jdec=jax.jit(jm.decode))
        if dtype == "bfloat16" and arch in NOISY:
            jm32 = jax_build(dataclasses.replace(
                jcfg, dtype="float32", param_dtype="float32"))
            lm.update(jm32=jm32, jdec32=jax.jit(jm32.decode),
                      jp32=jax.tree_util.tree_map(
                          lambda a: a.astype(jnp.float32), jp))
        _SETUPS[key] = lm
    return _SETUPS[key]


@pytest.fixture(params=list(TWINS))
def lm(request):
    return _setup(request.param)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _batches(lm, tok):
    """(reference batch, port batch) for tokens `tok`: with seeded f32
    `frames` (b, encoder_seq_len, d) for the audio family and
    `img_embeds` (b, num_image_tokens, d) for the vlm family, which each
    package casts to the model's dtype."""
    cfg = lm["cfg"]
    extra = {}
    r = np.random.default_rng(int(tok.sum()))
    if cfg.family == "audio":
        extra["frames"] = r.normal(
            size=(tok.shape[0], cfg.encoder_seq_len, cfg.d_model))
    if cfg.family == "vlm":
        extra["img_embeds"] = r.normal(
            size=(tok.shape[0], cfg.num_image_tokens, cfg.d_model))
    extra = {k: v.astype(np.float32) for k, v in extra.items()}
    return ({"tokens": jnp.asarray(tok),
             **{k: jnp.asarray(v) for k, v in extra.items()}},
            {"tokens": torch.tensor(tok),
             **{k: torch.tensor(v) for k, v in extra.items()}})


def _positions(lm, s):
    """Positions a forward over s tokens gives logits for."""
    cfg = lm["cfg"]
    return s + (cfg.num_image_tokens if cfg.family == "vlm" else 0)


def _spec(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_carry_over_is_exact(lm):
    """Every leaf of the reference tree, bit for bit, in the port's tree,
    in its spec's dtype (the router and the mamba f32 leaves stay f32 in
    a bf16 model)."""
    flat = jax.tree_util.tree_flatten_with_path(lm["jp"])[0]
    assert len(flat) == LEAVES[lm["arch"]]
    for path, leaf in flat:
        node = _spec(lm["p"], path)
        assert node.dtype == _spec(lm["m"].param_tree, path).dtype
        if node.dtype != torch.float32:
            assert node.dtype == DTYPES[lm["dtype"]]
        assert np.array_equal(node.float().numpy(),
                              np.asarray(leaf, np.float32))


def _ref_forward(lm, tok, f32=False):
    """(logits, aux) of the reference's forward (its f32 twin with `f32`)
    on `tok`, computed once per twin."""
    key = ("forward32" if f32 else "forward", tok.tobytes())
    if key not in lm:
        jm, jp = (lm["jm32"], lm["jp32"]) if f32 else (lm["jm"], lm["jp"])
        lm[key] = jax.jit(jm.forward)(jp, _batches(lm, tok)[0])
    return lm[key]


def test_forward_logits(lm):
    """Logits, and the experts' aux loss summed over the MoE layers (0
    without experts)."""
    tok = _tokens(lm["cfg"], (B, PROMPT), 1)
    want, want_aux = _ref_forward(lm, tok)
    got, aux = lm["m"].forward(lm["p"], _batches(lm, tok)[1])
    assert got.shape == (B, _positions(lm, PROMPT), lm["cfg"].padded_vocab())
    if lm["cfg"].num_experts:
        assert float(aux) > 0
        np.testing.assert_allclose(float(aux), float(want_aux),
                                   **TOL[lm["dtype"]])
    else:
        assert float(aux) == float(want_aux) == 0.0
    want32 = _ref_forward(lm, tok, f32=True)[0] if "jm32" in lm else None
    _agree(lm, got, want, want32)


@pytest.mark.parametrize("arch", NOISY)
def test_bf16_noise_premise(arch):
    """Why the `NOISY` twins are held by the noise rule in bf16: the
    reference's own bf16 forward leaves its f32 forward on the same
    weights by more than the 2e-2 elementwise limit in some logits; for
    qwen1.5-32b, whose forward writes no cache, its bf16 decode over the
    f8 cache leaves its f32 decode (fed the same tokens) so."""
    lm = _setup(f"{arch}-bfloat16")
    if lm["cfg"].cache_dtype == "float8_e4m3fn":
        zero = np.zeros((B, 1), np.int32)
        want, w16, _ = _run_reference(lm, 8, zero)
        fed = np.concatenate([zero[None], want[:-1]])
        _, w32, _ = _run_reference(lm, 8, zero, f32=True, inputs=fed)
    else:
        tok = _tokens(lm["cfg"], (B, PROMPT), 1)
        w16 = np.asarray(_ref_forward(lm, tok)[0], np.float32)
        w32 = np.asarray(_ref_forward(lm, tok, f32=True)[0], np.float32)
    assert (np.abs(w16 - w32) > 2e-2 + 2e-2 * np.abs(w32)).any()


def test_forward_hidden_f32():
    """`return_hidden` (the view driver's encoder input) in f32: in bf16
    the final norm's output is itself rounded to bf16, a few ulps apart."""
    lm = _setup("float32")
    tok = torch.tensor(_tokens(lm["cfg"], (B, PROMPT), 1))
    hidden, _ = lm["m"].forward(lm["p"], {"tokens": tok}, return_hidden=True)
    want, _ = lm["jm"].forward(lm["jp"], {"tokens": jnp.asarray(tok.numpy())},
                               return_hidden=True)
    assert hidden.shape == (B, PROMPT, lm["cfg"].d_model)
    _close(hidden, want, "float32")


def test_prefill_step(lm):
    tok = _tokens(lm["cfg"], (B, PROMPT), 2)
    batch, port_batch = _batches(lm, tok)
    want = jax.jit(JS.make_prefill_step(lm["jm"]))(lm["jp"], batch)
    got = S.make_prefill_step(lm["m"])(lm["p"], port_batch)
    assert got.shape == (B, lm["cfg"].padded_vocab())
    want32 = (jax.jit(JS.make_prefill_step(lm["jm32"]))(lm["jp32"], batch)
              if "jm32" in lm else None)
    _agree(lm, got, want, want32)


def _run_reference(lm, steps, start_tok, start=0, cache=None, inputs=None,
                   f32=False, caches=None):
    """Reference greedy decode from `start_tok` (or, given `inputs`
    (steps, b, 1), those tokens fed in turn); with `f32` the reference's
    f32 twin; each step's cache appended to `caches` (numpy) if given.
    Returns (greedy tokens (steps, b, 1), logits (steps, b, padded
    vocab), cache)."""
    jm, jp, dec = ((lm["jm32"], lm["jp32"], lm["jdec32"]) if f32
                   else (lm["jm"], lm["jp"], lm["jdec"]))
    jc = cache if cache is not None else JS.init_cache(jm, B, CACHE)
    tok = np.asarray(start_tok)
    toks, logits = [], []
    for j, i in enumerate(range(start, start + steps)):
        if inputs is not None:
            tok = inputs[j]
        lg, jc = dec(jp, jc, jnp.asarray(tok), jnp.asarray(i, jnp.int32))
        lg = np.asarray(lg[:, -1], np.float32)
        tok = lg.argmax(-1).astype(np.int32)[:, None]
        toks.append(tok)
        logits.append(lg)
        if caches is not None:
            caches.append(_np(jc))
    return np.stack(toks), np.stack(logits), jc


def _f8_bytes_equal(cache, want, step):
    """Every f8 leaf of the port's cache has the reference's bytes."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    n = 0
    for (path, w), g in zip(flat, jax.tree_util.tree_leaves(cache)):
        if g.dtype == torch.float8_e4m3fn:
            assert np.array_equal(g.view(torch.uint8).numpy(),
                                  np.asarray(w).view(np.uint8)), (
                step, jax.tree_util.keystr(path))
            n += 1
    return n


def _decode_port(lm, cache, steps, start_tok, start, want,
                 want_caches=None):
    """The port's decode steps from `start_tok` at `start`: f32 feeds its
    own greedy tokens, which must equal the reference's (`want`); bf16 is
    fed the reference's tokens (teacher forcing) and every step's greedy
    token agrees, except on a noisy twin, whose logits (steps, b, padded
    vocab) are returned for the noise rule. Given the reference's cache of
    each step (`want_caches`), every f8 leaf has its bytes after every
    step. Returns (logits, cache)."""
    dec = S.make_decode_step(lm["m"])
    tok = torch.tensor(start_tok)
    logits = []
    for j in range(steps):
        if lm["dtype"] == "bfloat16" and j:
            tok = torch.tensor(want[j - 1])
        if "jm32" in lm:
            lg, cache = lm["m"].decode(lm["p"], cache, tok, start + j)
            logits.append(lg[:, -1])
        else:
            tok, cache = dec(lm["p"], cache, tok, start + j)
            assert tok.dtype == torch.int32 and tok.shape == (B, 1)
            assert np.array_equal(tok.numpy(), want[j]), j
        if want_caches is not None:
            assert _f8_bytes_equal(cache, want_caches[j], start + j)
    return logits, cache


def _f8_steps(lm):
    """A list to collect the reference's cache of every step in where the
    twin's f8 cache is held byte for byte: in f32 (in bf16 the two
    packages' attention rounds differently, and k/v a bf16 ulp apart can
    land in different e4m3 values), else None."""
    cfg = lm["cfg"]
    if cfg.cache_dtype == "float8_e4m3fn" and lm["dtype"] == "float32":
        return []
    return None


def test_decode_from_a_zero_cache(lm):
    """8 greedy steps. f32: the port feeds itself and its tokens equal the
    reference's. bf16: both are fed the reference's tokens, and every
    step's greedy token agrees (a noisy twin: its logits and cache by the
    noise rule, the reference's f32 twin fed the same tokens). Every
    cache leaf (k/v, the mamba state) agrees after them."""
    zero = np.zeros((B, 1), np.int32)
    steps_f8 = _f8_steps(lm)
    want, want_lg, jc = _run_reference(lm, 8, zero, caches=steps_f8)
    cache = S.init_cache(lm["m"], B, CACHE, device="cpu")
    logits, cache = _decode_port(lm, cache, 8, zero, 0, want, steps_f8)
    if "jm32" in lm:
        fed = np.concatenate([zero[None], want[:-1]])
        _, lg32, jc32 = _run_reference(lm, 8, zero, inputs=fed, f32=True)
        _agree(lm, logits, want_lg, lg32)
        _agree(lm, cache, _np(jc), _np(jc32))
    else:
        _agree(lm, cache, _np(jc))


def test_cache_carried_across_mid_stream(lm):
    """3 reference steps, then the cache and last token carried across:
    5 more steps in the port equal 5 more in the reference."""
    first, _, jc = _run_reference(lm, 3, np.zeros((B, 1), np.int32))
    cache = cache_from_reference(_np(jc), lm["cfg"], device="cpu")
    specs = lm["m"].cache_specs(B, CACHE)
    got_shapes = [tuple(x.shape) for x in jax.tree_util.tree_leaves(cache)]
    assert got_shapes == [s.shape for s in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: hasattr(x, "init"))]
    if lm["arch"] == ARCH:
        assert cache["blocks"]["pos0"]["k"].shape == (
            lm["cfg"].num_layers, B, CACHE, lm["cfg"].num_kv_heads,
            lm["cfg"].head_dim)
    carried = _np(jc)
    if _f8_steps(lm) is not None:
        assert _f8_bytes_equal(cache, carried, 2) == 2      # k and v
    steps_f8 = _f8_steps(lm)
    want, want_lg, jc = _run_reference(lm, 5, first[-1], start=3, cache=jc,
                                       caches=steps_f8)
    logits, cache = _decode_port(lm, cache, 5, first[-1], 3, want, steps_f8)
    if "jm32" in lm:
        fed = np.concatenate([first[-1:], want[:-1]])
        jc32 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float32) if a.dtype.name
            == "bfloat16" else jnp.asarray(a), carried)
        _, lg32, jc32 = _run_reference(lm, 5, first[-1], start=3,
                                       cache=jc32, inputs=fed, f32=True)
        _agree(lm, logits, want_lg, lg32)
        _agree(lm, cache, _np(jc), _np(jc32))
    else:
        _agree(lm, cache, _np(jc))


def _reference_cross_cache(lm, frames, cache):
    """The reference's decode cache with every decoder layer's cross k/v
    filled from `encode_kv` of its encoder output, composed from the
    reference's own functions as its `_forward_encdec` runs them."""
    from repro.models import layers as JL
    from repro.models import transformer as JT
    jcfg, jp = lm["jcfg"], lm["jp"]
    enc = jnp.asarray(frames).astype(jcfg.dtype)
    enc = enc + JT._sinusoidal(enc.shape[1], jcfg.d_model, jcfg.dtype)[None]
    for l in range(jcfg.num_encoder_layers):
        p = jax.tree_util.tree_map(lambda a: a[l], jp["enc_blocks"])
        enc = enc + JT._bidir_attention(
            p["attn"], jcfg, JT.apply_norm(jcfg, p["ln1"], enc))
        enc = enc + JL.mlp(p["mlp"], JT.apply_norm(jcfg, p["ln2"], enc),
                           act=jax.nn.gelu)
    enc = JT.apply_norm(jcfg, jp["enc_norm"], enc)
    ks, vs = zip(*(JL.encode_kv(
        jax.tree_util.tree_map(lambda a: a[l], jp["dec_blocks"]["xattn"]),
        jcfg, enc) for l in range(jcfg.num_layers)))
    cross = {"k": jnp.stack(ks).astype(jcfg.dtype),
             "v": jnp.stack(vs).astype(jcfg.dtype)}
    return {"dec": {**cache["dec"], "cross": cross}}


def _port_cross_cache(lm, frames, cache):
    """The port's cache with the cross k/v filled the same way, from
    `ModelDef.encode` and `layers.encode_kv`, in place."""
    from repro_torch.models import layers as L
    m, p = lm["m"], lm["p"]
    enc = m.encode(p, torch.tensor(frames))
    for l in range(m.cfg.num_layers):
        xattn = {k: w[l] for k, w in p["dec_blocks"]["xattn"].items()}
        k, v = L.encode_kv(xattn, m.cfg, enc)
        cache["dec"]["cross"]["k"][l].copy_(k)
        cache["dec"]["cross"]["v"][l].copy_(v)
    return cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_decode_against_an_encoded_cross_cache(dtype):
    """whisper-tiny's twin: with every layer's cross cache filled from
    `encode_kv` of the encoder output (in both packages the same way),
    decode fed the prompt's tokens gives, position by position, the
    forward's logits (the port's own and the reference's); the filled
    cross caches agree; and the reference's decode over its filled cache
    gives its forward's logits too (the premise)."""
    lm = _setup(f"whisper-tiny-{dtype}")
    tok = _tokens(lm["cfg"], (B, CACHE), 3)
    batch, port_batch = _batches(lm, tok)
    frames = np.asarray(batch["frames"])
    want = np.asarray(_ref_forward(lm, tok)[0], np.float32)
    fwd, _ = lm["m"].forward(lm["p"], port_batch)
    _close(fwd, want, dtype)
    jc = _reference_cross_cache(lm, frames, JS.init_cache(lm["jm"], B, CACHE))
    cache = _port_cross_cache(
        lm, frames, S.init_cache(lm["m"], B, CACHE, device="cpu"))
    for kv in ("k", "v"):
        _close(cache["dec"]["cross"][kv], jc["dec"]["cross"][kv], dtype)
    _, ref_lg, _ = _run_reference(lm, CACHE, tok[:, :1], cache=jc,
                                  inputs=tok.T[:, :, None])
    _close(torch.tensor(ref_lg), want.transpose(1, 0, 2), dtype)
    for i in range(CACHE):
        lg, cache = lm["m"].decode(lm["p"], cache,
                                   torch.tensor(tok[:, i:i + 1]), i)
        _close(lg[:, -1], want[:, i], dtype)
        _close(lg[:, -1], fwd[:, i].float().numpy(), dtype)


def _padded_mha(jax_or_port, cache_dtype=""):
    """An MHA-padded smoke config (4 kv heads, padded to 8 by the
    reference) in f32; its cache of `cache_dtype` ("" the model's)."""
    return dataclasses.replace(
        jax_or_port("qwen1.5-32b"), dtype="float32", param_dtype="float32",
        kv_cache_dtype=cache_dtype, head_pad_to=8, num_kv_heads=4)


def test_padded_mha_cache_carried_across():
    """The reference's cache of an MHA-padded config has 8 kv heads, the
    last 4 zero; carried across it has the port's 4, and 5 more greedy
    steps in the port equal 5 more in the reference."""
    jcfg, cfg = _padded_mha(jax_smoke), _padded_mha(smoke_config)
    assert cfg.mha_padded and cfg.padded_heads == 8
    jm, m = jax_build(jcfg), build(cfg)
    jp = JS.init_train_state(jm, 0)["params"]
    p = params_from_reference(_np(jp), cfg, device="cpu")
    lm = dict(jm=jm, jp=jp, jdec=jax.jit(jm.decode))
    first, _, jc = _run_reference(lm, 3, np.zeros((B, 1), np.int32))
    assert np.shape(jc["blocks"]["pos0"]["k"])[3] == 8
    cache = cache_from_reference(_np(jc), cfg, device="cpu")
    assert cache["blocks"]["pos0"]["k"].shape == (
        cfg.num_layers, B, CACHE, 4, cfg.head_dim)
    want, _, jc = _run_reference(lm, 5, first[-1], start=3, cache=jc)
    dec = S.make_decode_step(m)
    tok = torch.tensor(first[-1])
    for j in range(5):
        tok, cache = dec(p, cache, tok, 3 + j)
        assert np.array_equal(tok.numpy(), want[j]), j
    for kv in ("k", "v"):
        _close(cache["blocks"]["pos0"][kv],
               np.asarray(jc["blocks"]["pos0"][kv])[:, :, :, :4], "float32")

    bad = _np(jc)
    bad["blocks"]["pos0"]["v"] = np.array(bad["blocks"]["pos0"]["v"])
    bad["blocks"]["pos0"]["v"][0, 0, 0, 5, 0] = 1.0
    with pytest.raises(ValueError, match="padded kv heads"):
        cache_from_reference(bad, cfg, device="cpu")


def test_padded_mha_f8_cache_carried_across():
    """qwen1.5-32b's own layout at a smoke size: MHA padded to 8 heads
    with the f8 e4m3fn cache. The reference's padded f8 cache carries
    across cut to the 4 real heads, bytes equal, and 5 more greedy steps
    leave the port's cache bytes equal to the reference's real heads."""
    jcfg = _padded_mha(jax_smoke, "float8_e4m3fn")
    cfg = _padded_mha(smoke_config, "float8_e4m3fn")
    assert cfg.mha_padded and cfg.cache_dtype == "float8_e4m3fn"
    jm, m = jax_build(jcfg), build(cfg)
    jp = JS.init_train_state(jm, 0)["params"]
    p = params_from_reference(_np(jp), cfg, device="cpu")
    lm = dict(jm=jm, jp=jp, jdec=jax.jit(jm.decode))
    first, _, jc = _run_reference(lm, 3, np.zeros((B, 1), np.int32))
    cache = cache_from_reference(_np(jc), cfg, device="cpu")
    want, _, jc = _run_reference(lm, 5, first[-1], start=3, cache=jc)
    dec = S.make_decode_step(m)
    tok = torch.tensor(first[-1])
    for j in range(5):
        tok, cache = dec(p, cache, tok, 3 + j)
        assert np.array_equal(tok.numpy(), want[j]), j
    for kv in ("k", "v"):
        got = cache["blocks"]["pos0"][kv]
        assert got.dtype == torch.float8_e4m3fn and got.shape[3] == 4
        assert np.array_equal(got.view(torch.uint8).numpy(), np.asarray(
            jc["blocks"]["pos0"][kv])[:, :, :, :4].view(np.uint8))


def test_serve_decode_on_the_cpu(capsys):
    """`serve_decode` on the (bf16) smoke twin with the reference's
    weights gives the reference serving loop's tokens."""
    lm = _setup("bfloat16")
    steps = 6
    run = serve.serve_decode(ARCH, steps, B, CACHE, smoke=True, device="cpu",
                             params=lm["p"])
    assert "tok/s" in capsys.readouterr().out
    assert run.tokens.shape == (B, steps) and run.step_ms is None
    want, _, _ = _run_reference(lm, steps, np.zeros((B, 1), np.int32))
    assert np.array_equal(run.tokens.numpy(), want[:, :, 0].T)


def test_serve_cli_and_pending_modes(capsys):
    serve.main(["--mode", "decode", "--smoke", "--device", "cpu", "--steps",
                "3", "--batch", "2", "--cache-len", "4"])
    assert "3 steps x batch 2" in capsys.readouterr().out
    ex = serve.main(["--mode", "sql", "--device", "cpu", "--execute",
                     "SHOW TABLES"])
    assert "(0 rows)" in capsys.readouterr().out
    assert ex.catalog.device.type == "cpu" and not ex.catalog.tables
    serve.main(["--mode", "view", "--device", "cpu", "--requests", "20"])
    assert "view exact" in capsys.readouterr().out
    with pytest.raises(ValueError, match="overrun"):
        serve.serve_decode(ARCH, 5, 1, 4, smoke=True, device="cpu")


@pytest.mark.parametrize("arch", NOISY[1:] + ("whisper-tiny",
                                              "pixtral-12b"))
def test_serve_new_families_on_the_cpu(arch, capsys):
    """`serve --mode decode --smoke --arch ...` through the CLI, then
    `serve_decode` on the bf16 smoke twin with the reference's weights:
    its tokens are the port's own greedy loop's (held to the reference
    above), and the cache bounds the steps as for the dense family."""
    serve.main(["--mode", "decode", "--smoke", "--device", "cpu", "--arch",
                arch, "--steps", "3", "--batch", "2", "--cache-len", "4"])
    assert "3 steps x batch 2" in capsys.readouterr().out
    lm = _setup(f"{arch}-bfloat16")
    steps = 6
    run = serve.serve_decode(arch, steps, B, CACHE, smoke=True, device="cpu",
                             params=lm["p"])
    assert run.tokens.shape == (B, steps) and run.step_ms is None
    dec = S.make_decode_step(lm["m"])
    cache = S.init_cache(lm["m"], B, CACHE, device="cpu")
    tok, want = torch.zeros((B, 1), dtype=torch.int32), []
    for i in range(steps):
        tok, cache = dec(lm["p"], cache, tok, i)
        want.append(tok)
    assert torch.equal(run.tokens, torch.cat(want, 1))
    with pytest.raises(ValueError, match="overrun"):
        serve.serve_decode(arch, 5, 1, 4, smoke=True, device="cpu")


def test_attn_logit_softcap_is_read_nowhere():
    """The reference reads `attn_logit_softcap` nowhere (it is declared in
    `configs/base.py` only), so a config that sets it computes what it
    computes without it; the port's logits equal the reference's, and
    those with the field at 0."""
    cfgs = [dataclasses.replace(config("llama4-scout-17b-a16e"),
                                dtype="float32", param_dtype="float32",
                                attn_logit_softcap=cap)
            for config in (jax_smoke, smoke_config) for cap in (30.0, 0.0)]
    jm30, jm0 = jax_build(cfgs[0]), jax_build(cfgs[1])
    jp = JS.init_train_state(jm30, 0)["params"]
    tok = _tokens(cfgs[2], (B, 16), 4)
    want30 = np.asarray(jm30.forward(jp, {"tokens": jnp.asarray(tok)})[0])
    want0 = np.asarray(jm0.forward(jp, {"tokens": jnp.asarray(tok)})[0])
    assert np.array_equal(want30, want0)
    got = [build(c).forward(params_from_reference(_np(jp), c, device="cpu"),
                            {"tokens": torch.tensor(tok)})[0]
           for c in cfgs[2:]]
    assert torch.equal(got[0], got[1])
    _close(got[0], want30, "float32")


def _specs(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "init"))[0]


ARCHS = ("tinyllama-1.1b", "granite-3-2b", "qwen3-14b", "qwen1.5-32b",
         "rwkv6-3b", "llama4-scout-17b-a16e", "dbrx-132b", "jamba-v0.1-52b",
         "whisper-tiny", "pixtral-12b")


def _specs_equal(jcfg, cfg):
    """The port's parameter tree and decode cache equal the reference's
    spec for spec: path, shape, dtype, logical axes, init and scale. An
    MHA-padded config's k/v caches (whisper-tiny's self and cross,
    qwen1.5-32b's) hold the `num_kv_heads` real heads where the
    reference's hold `padded_heads` (zero past the real ones,
    `cache_from_reference`)."""
    jm, m = jax_build(jcfg), build(cfg)
    for want, got in ((jm.param_tree, m.param_tree),
                      (jm.cache_specs(2, 16), m.cache_specs(2, 16))):
        want, got = _specs(want), _specs(got)
        assert [jax.tree_util.keystr(k) for k, _ in got] == [
            jax.tree_util.keystr(k) for k, _ in want]
        for (path, w), (_, g) in zip(want, got):
            shape = tuple(w.shape)
            if cfg.mha_padded and path[-1].key in ("k", "v"):
                assert shape[-2] == cfg.padded_heads
                shape = shape[:-2] + (cfg.num_kv_heads, shape[-1])
            assert (g.shape, g.axes, g.init, g.scale) == (
                shape, tuple(w.axes), w.init, w.scale), path
            assert (str(g.dtype).replace("torch.", "")
                    == jnp.dtype(w.dtype).name), path


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_specs_equal_the_reference(arch):
    """At full size (specs only, nothing allocated), every registered
    config: `_specs_equal`."""
    _specs_equal(jax_config(arch), get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_specs_equal_the_reference(arch):
    """The smoke twin of every registered config: `_specs_equal`."""
    _specs_equal(jax_smoke(arch), smoke_config(arch))


def test_every_registered_arch_is_covered():
    from repro.configs import ARCHS as REGISTERED
    assert sorted(ARCHS) == sorted(REGISTERED)
