"""The port's LM serving path against the reference on the smoke twins
of tinyllama-1.1b, granite-3-2b and qwen3-14b (dense), llama4-scout-17b-a16e
(moe, top-1 with a shared expert; also with padded q heads), dbrx-132b
(moe, top-2) and jamba-v0.1-52b (hybrid: attention, mamba, dense and MoE
FFNs), in f32 and in bf16: the reference's `init_train_state` params are
carried across (`core/convert.py`), then `forward` (with the experts' aux
loss), the prefill step, greedy decode from a zero cache, a decode cache
carried across mid-stream (k/v and the mamba state), and
`serve_decode(..., device="cpu")`. f32: logits within 1e-5, caches
within 1e-5, tokens equal. bf16: logits and caches within 2e-2, the
reference test's bf16 tolerance (the two frameworks sum in different
orders, and the reference rounds attention logits to bf16 where the
port's kernels keep f32), tokens equal on the reference's own tokens fed
to both (teacher forcing); qwen3-14b and the moe and hybrid twins in bf16
by the noise rule (`NOISY`). Then, without allocating, every registered
config the port builds has the reference's parameter and cache specs."""
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
                    "dbrx-132b", "jamba-v0.1-52b")
       for dtype in ("float32", "bfloat16")},
    "llama4-scout-padded-float32": (
        "llama4-scout-17b-a16e", "float32",
        dict(num_heads=6, num_kv_heads=2, head_pad_to=8)),
}
LEAVES = {ARCH: 12, "granite-3-2b": 12, "qwen3-14b": 14,
          "llama4-scout-17b-a16e": 16, "dbrx-132b": 13,
          "jamba-v0.1-52b": 56}
# these bf16 twins are held by the noise rule: their bf16 noise passes
# 2e-2 in some logits between the two packages as it does between the
# reference's own bf16 and f32 runs (`test_bf16_noise_premise`: a route
# flips at a near tie of two experts' probabilities, jamba's mamba chain
# drifts, qwen3-14b's q/k norms round to bf16). So the port's bf16 must
# lie as close to the reference's f32 result on the same weights as the
# reference's bf16 does, within a factor NOISE_RATIO; a wrong rounding
# point (a state or router kept in bf16) multiplies the distance instead.
NOISY = ("qwen3-14b", "llama4-scout-17b-a16e", "dbrx-132b",
         "jamba-v0.1-52b")
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
        lm[key] = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tok)})
    return lm[key]


def test_forward_logits(lm):
    """Logits, and the experts' aux loss summed over the MoE layers (0
    without experts)."""
    tok = _tokens(lm["cfg"], (B, PROMPT), 1)
    want, want_aux = _ref_forward(lm, tok)
    got, aux = lm["m"].forward(lm["p"], {"tokens": torch.tensor(tok)})
    assert got.shape == (B, PROMPT, lm["cfg"].padded_vocab())
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
    weights by more than the 2e-2 elementwise limit in some logits."""
    lm = _setup(f"{arch}-bfloat16")
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
    batch = {"tokens": jnp.asarray(tok)}
    want = jax.jit(JS.make_prefill_step(lm["jm"]))(lm["jp"], batch)
    got = S.make_prefill_step(lm["m"])(lm["p"], {"tokens": torch.tensor(tok)})
    assert got.shape == (B, lm["cfg"].padded_vocab())
    want32 = (jax.jit(JS.make_prefill_step(lm["jm32"]))(lm["jp32"], batch)
              if "jm32" in lm else None)
    _agree(lm, got, want, want32)


def _run_reference(lm, steps, start_tok, start=0, cache=None, inputs=None,
                   f32=False):
    """Reference greedy decode from `start_tok` (or, given `inputs`
    (steps, b, 1), those tokens fed in turn); with `f32` the reference's
    f32 twin. Returns (greedy tokens (steps, b, 1), logits (steps, b,
    padded vocab), cache)."""
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
    return np.stack(toks), np.stack(logits), jc


def _decode_port(lm, cache, steps, start_tok, start, want):
    """The port's decode steps from `start_tok` at `start`: f32 feeds its
    own greedy tokens, which must equal the reference's (`want`); bf16 is
    fed the reference's tokens (teacher forcing) and every step's greedy
    token agrees, except on a noisy twin, whose logits (steps, b, padded
    vocab) are returned for the noise rule. Returns (logits, cache)."""
    dec = S.make_decode_step(lm["m"])
    tok = torch.tensor(start_tok)
    logits = []
    for j in range(steps):
        if lm["dtype"] == "bfloat16" and j:
            tok = torch.tensor(want[j - 1])
        if "jm32" in lm:
            lg, cache = lm["m"].decode(lm["p"], cache, tok, start + j)
            logits.append(lg[:, -1])
            continue
        tok, cache = dec(lm["p"], cache, tok, start + j)
        assert tok.dtype == torch.int32 and tok.shape == (B, 1)
        assert np.array_equal(tok.numpy(), want[j]), j
    return logits, cache


def test_decode_from_a_zero_cache(lm):
    """8 greedy steps. f32: the port feeds itself and its tokens equal the
    reference's. bf16: both are fed the reference's tokens, and every
    step's greedy token agrees (a noisy twin: its logits and cache by the
    noise rule, the reference's f32 twin fed the same tokens). Every
    cache leaf (k/v, the mamba state) agrees after them."""
    zero = np.zeros((B, 1), np.int32)
    want, want_lg, jc = _run_reference(lm, 8, zero)
    cache = S.init_cache(lm["m"], B, CACHE, device="cpu")
    logits, cache = _decode_port(lm, cache, 8, zero, 0, want)
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
    want, want_lg, jc = _run_reference(lm, 5, first[-1], start=3, cache=jc)
    logits, cache = _decode_port(lm, cache, 5, first[-1], 3, want)
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


@pytest.mark.parametrize("arch", NOISY[1:])
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


@pytest.mark.parametrize("arch,match", [
    ("whisper-tiny", "family 'audio'"),
    ("pixtral-12b", "family 'vlm'"),
    ("qwen1.5-32b", "f8 KV cache"),
])
def test_unported_families_raise(arch, match):
    with pytest.raises(NotImplementedError, match=match):
        build(smoke_config(arch))


def test_attn_logit_softcap_raises():
    cfg = dataclasses.replace(smoke_config("llama4-scout-17b-a16e"),
                              attn_logit_softcap=30.0)
    with pytest.raises(NotImplementedError, match="attn_logit_softcap"):
        build(cfg)


def _specs(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "init"))[0]


@pytest.mark.parametrize("arch", [
    "tinyllama-1.1b", "granite-3-2b", "qwen3-14b", "rwkv6-3b",
    "llama4-scout-17b-a16e", "dbrx-132b", "jamba-v0.1-52b"])
def test_full_size_specs_equal_the_reference(arch):
    """At full size (specs only, nothing allocated) the port's parameter
    tree and decode cache equal the reference's spec for spec: path,
    shape, dtype, logical axes, init and scale."""
    jm, m = jax_build(jax_config(arch)), build(get_config(arch))
    for want, got in ((jm.param_tree, m.param_tree),
                      (jm.cache_specs(2, 16), m.cache_specs(2, 16))):
        want, got = _specs(want), _specs(got)
        assert [jax.tree_util.keystr(k) for k, _ in got] == [
            jax.tree_util.keystr(k) for k, _ in want]
        for (path, w), (_, g) in zip(want, got):
            assert (g.shape, g.axes, g.init, g.scale) == (
                tuple(w.shape), tuple(w.axes), w.init, w.scale), path
            assert (str(g.dtype).replace("torch.", "")
                    == jnp.dtype(w.dtype).name), path
