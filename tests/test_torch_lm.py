"""The port's dense LM serving path against the reference on
`smoke_config("tinyllama-1.1b")`, in f32 and in bf16: the reference's
`init_train_state` params are carried across (`core/convert.py`), then
`forward`, the prefill step, greedy decode from a zero cache, a decode
cache carried across mid-stream, and `serve_decode(..., device="cpu")`.
f32: logits within 1e-5, caches within 1e-5, tokens equal. bf16: logits
and caches within 2e-2, the reference test's bf16 tolerance (the two
frameworks sum in different orders, and the reference rounds attention
logits to bf16 where the port's kernels keep f32), tokens equal on the
reference's own tokens fed to both (teacher forcing)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.configs import smoke_config as jax_smoke         # noqa: E402
from repro.models import build as jax_build                 # noqa: E402
from repro.models import steps as JS                        # noqa: E402

from repro_torch.configs import smoke_config                # noqa: E402
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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


_SETUPS = {}


def _setup(dtype):
    """The reference model and params of the smoke twin in `dtype`, and
    the port's model with the params carried across (made once)."""
    if dtype not in _SETUPS:
        jcfg = dataclasses.replace(jax_smoke(ARCH), dtype=dtype,
                                   param_dtype=dtype)
        cfg = dataclasses.replace(smoke_config(ARCH), dtype=dtype,
                                  param_dtype=dtype)
        jm, m = jax_build(jcfg), build(cfg)
        jp = JS.init_train_state(jm, 0)["params"]
        _SETUPS[dtype] = dict(
            dtype=dtype, jcfg=jcfg, cfg=cfg, jm=jm, m=m, jp=jp,
            p=params_from_reference(_np(jp), cfg, device="cpu"),
            jdec=jax.jit(JS.make_decode_step(jm)))
    return _SETUPS[dtype]


@pytest.fixture(params=["float32", "bfloat16"])
def lm(request):
    return _setup(request.param)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_carry_over_is_exact(lm):
    """Every leaf of the reference tree, bit for bit, in the port's tree."""
    flat = jax.tree_util.tree_flatten_with_path(lm["jp"])[0]
    assert len(flat) == 12
    for path, leaf in flat:
        node = lm["p"]
        for key in path:
            node = node[key.key]
        assert node.dtype == DTYPES[lm["dtype"]]
        assert np.array_equal(node.float().numpy(),
                              np.asarray(leaf, np.float32))


def test_forward_logits(lm):
    tok = _tokens(lm["cfg"], (B, PROMPT), 1)
    want, _ = jax.jit(lm["jm"].forward)(lm["jp"], {"tokens": jnp.asarray(tok)})
    got, aux = lm["m"].forward(lm["p"], {"tokens": torch.tensor(tok)})
    assert got.shape == (B, PROMPT, lm["cfg"].padded_vocab())
    assert float(aux) == 0.0
    _close(got, want, lm["dtype"])


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
    want = jax.jit(JS.make_prefill_step(lm["jm"]))(
        lm["jp"], {"tokens": jnp.asarray(tok)})
    got = S.make_prefill_step(lm["m"])(lm["p"], {"tokens": torch.tensor(tok)})
    assert got.shape == (B, lm["cfg"].padded_vocab())
    _close(got, want, lm["dtype"])


def _run_reference(lm, steps, start_tok, start=0, cache=None):
    """Reference greedy decode; returns (tokens (steps, b), cache)."""
    jc = cache if cache is not None else JS.init_cache(lm["jm"], B, CACHE)
    tok = jnp.asarray(start_tok)
    out = []
    for i in range(start, start + steps):
        tok, jc = lm["jdec"](lm["jp"], jc, tok, jnp.asarray(i, jnp.int32))
        out.append(np.asarray(tok))
    return np.stack(out), jc


def test_decode_from_a_zero_cache(lm):
    """8 greedy steps. f32: the port feeds itself and its tokens equal the
    reference's. bf16: both are fed the reference's tokens, and every
    step's greedy token agrees."""
    dtype = lm["dtype"]
    want, jc = _run_reference(lm, 8, np.zeros((B, 1), np.int32))
    cache = S.init_cache(lm["m"], B, CACHE, device="cpu")
    dec = S.make_decode_step(lm["m"])
    tok = torch.zeros((B, 1), dtype=torch.int32)
    for i in range(8):
        if dtype == "bfloat16" and i:
            tok = torch.tensor(want[i - 1])
        tok, cache = dec(lm["p"], cache, tok, i)
        assert tok.dtype == torch.int32 and tok.shape == (B, 1)
        assert np.array_equal(tok.numpy(), want[i]), i
    for kv in ("k", "v"):
        _close(cache["blocks"]["pos0"][kv], jc["blocks"]["pos0"][kv], dtype)


def test_cache_carried_across_mid_stream(lm):
    """3 reference steps, then the cache and last token carried across:
    5 more steps in the port equal 5 more in the reference."""
    dtype = lm["dtype"]
    first, jc = _run_reference(lm, 3, np.zeros((B, 1), np.int32))
    cache = cache_from_reference(_np(jc), lm["cfg"], device="cpu")
    assert cache["blocks"]["pos0"]["k"].shape == (
        lm["cfg"].num_layers, B, CACHE, lm["cfg"].num_kv_heads,
        lm["cfg"].head_dim)
    want, jc = _run_reference(lm, 5, first[-1], start=3, cache=jc)
    dec = S.make_decode_step(lm["m"])
    tok = torch.tensor(first[-1])
    for j in range(5):
        if dtype == "bfloat16" and j:
            tok = torch.tensor(want[j - 1])
        tok, cache = dec(lm["p"], cache, tok, 3 + j)
        assert np.array_equal(tok.numpy(), want[j]), j
    for kv in ("k", "v"):
        _close(cache["blocks"]["pos0"][kv], jc["blocks"]["pos0"][kv], dtype)


def _padded_mha(jax_or_port):
    """An MHA-padded smoke config (4 kv heads, padded to 8 by the
    reference) in f32, without the f8 cache the port does not take yet."""
    return dataclasses.replace(
        jax_or_port("qwen1.5-32b"), dtype="float32", param_dtype="float32",
        kv_cache_dtype="", head_pad_to=8, num_kv_heads=4)


def test_padded_mha_cache_carried_across():
    """The reference's cache of an MHA-padded config has 8 kv heads, the
    last 4 zero; carried across it has the port's 4, and 5 more greedy
    steps in the port equal 5 more in the reference."""
    jcfg, cfg = _padded_mha(jax_smoke), _padded_mha(smoke_config)
    assert cfg.mha_padded and cfg.padded_heads == 8
    jm, m = jax_build(jcfg), build(cfg)
    jp = JS.init_train_state(jm, 0)["params"]
    p = params_from_reference(_np(jp), cfg, device="cpu")
    lm = dict(jm=jm, jp=jp, jdec=jax.jit(JS.make_decode_step(jm)))
    first, jc = _run_reference(lm, 3, np.zeros((B, 1), np.int32))
    assert np.shape(jc["blocks"]["pos0"]["k"])[3] == 8
    cache = cache_from_reference(_np(jc), cfg, device="cpu")
    assert cache["blocks"]["pos0"]["k"].shape == (
        cfg.num_layers, B, CACHE, 4, cfg.head_dim)
    want, jc = _run_reference(lm, 5, first[-1], start=3, cache=jc)
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


def test_serve_decode_on_the_cpu(capsys):
    """`serve_decode` on the (bf16) smoke twin with the reference's
    weights gives the reference serving loop's tokens."""
    lm = _setup("bfloat16")
    steps = 6
    run = serve.serve_decode(ARCH, steps, B, CACHE, smoke=True, device="cpu",
                             params=lm["p"])
    assert "tok/s" in capsys.readouterr().out
    assert run.tokens.shape == (B, steps) and run.step_ms is None
    want, _ = _run_reference(lm, steps, np.zeros((B, 1), np.int32))
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


@pytest.mark.parametrize("arch,match", [
    ("llama4-scout-17b-a16e", "family 'moe'"),
    ("jamba-v0.1-52b", "family 'hybrid'"),
    ("whisper-tiny", "family 'audio'"),
    ("pixtral-12b", "family 'vlm'"),
    ("qwen1.5-32b", "f8 KV cache"),
])
def test_unported_families_raise(arch, match):
    with pytest.raises(NotImplementedError, match=match):
        build(smoke_config(arch))
