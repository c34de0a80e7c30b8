"""The port's ssm family (RWKV-6, `models/rwkv6.py` and the ssm branches
of `models/transformer.py`) against the reference on
`smoke_config("rwkv6-3b")`, in f32 and in bf16.

The layers first, with random parameters drawn by numpy (the reference
initialises the mixing factors, `w0` and `u` to zero): `time_mix`,
`time_mix_decode` (output and state) and `channel_mix`, in f32 to 1e-5.
Then the model with the reference's `init_train_state` params carried
across (`core/convert.py`): `forward`, the prefill step, greedy decode from
a zero state, a state carried across mid-stream, teacher-forced decode
against prefill on a 32-token prompt (within one chunk's clip-free reach,
ROADMAP.md R3), and `serve_decode(..., device="cpu")`. f32: logits and
states within 1e-5, tokens equal. bf16: within 2e-2, the reference test's
bf16 tolerance (the two frameworks round bf16 intermediates at different
places), tokens equal on the reference's own tokens fed to both."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.configs import smoke_config as jax_smoke         # noqa: E402
from repro.models import build as jax_build                 # noqa: E402
from repro.models import rwkv6 as JR                        # noqa: E402
from repro.models import steps as JS                        # noqa: E402

from repro_torch.configs import smoke_config                # noqa: E402
from repro_torch.core.convert import (cache_from_reference,  # noqa: E402
                                      params_from_reference)
from repro_torch.launch import serve                        # noqa: E402
from repro_torch.models import build                        # noqa: E402
from repro_torch.models import rwkv6 as R                   # noqa: E402
from repro_torch.models import steps as S                   # noqa: E402
from repro_torch.models.params import DTYPES                # noqa: E402

ARCH = "rwkv6-3b"
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
B, PROMPT = 2, 48
STATE = ("S", "last", "cm_last")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# layers, f32, random parameters
# ---------------------------------------------------------------------------

def _random_params(specs, seed):
    """numpy draws for every leaf of a reference ParamSpec tree: mixing
    factors in [0, 1), everything else N(0, 1) scaled by 1/sqrt(fan in)."""
    rng = np.random.default_rng(seed)

    def draw(path, spec):
        name = path[-1].key
        if name.startswith("mu_"):
            return rng.uniform(size=spec.shape).astype(np.float32)
        scale = spec.shape[0] ** -0.5 if len(spec.shape) == 2 else 0.5
        return (rng.normal(size=spec.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, specs, is_leaf=lambda x: hasattr(x, "init"))


def _as_torch(tree):
    return {k: _as_torch(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def layer():
    jcfg = jax_smoke(ARCH)
    cfg = smoke_config(ARCH)
    tm = _random_params(JR.time_mix_params(jcfg), 1)
    cm = _random_params(JR.channel_mix_params(jcfg), 2)
    x = np.random.default_rng(3).normal(size=(B, 128, cfg.d_model)).astype(
        np.float32)
    return dict(jcfg=jcfg, cfg=cfg, tm=tm, cm=cm, x=x,
                tm_t=_as_torch(tm), cm_t=_as_torch(cm))


@pytest.mark.parametrize("s", [48, 128])
def test_time_mix(layer, s):
    """Prefill time mix; at s = 128 two chunks of 64, the clip binding in
    both at this decay (the port follows the reference's chunked form)."""
    x = layer["x"][:, :s]
    want = JR.time_mix(layer["tm"], layer["jcfg"], jnp.asarray(x))
    got = R.time_mix(layer["tm_t"], layer["cfg"], torch.tensor(x))
    assert got.shape == (B, s, layer["cfg"].d_model)
    _close(got, want, "float32")


def test_time_mix_decode(layer):
    """One exact step from a random state: output, and S and last written
    in place into the state's own tensors."""
    cfg = layer["cfg"]
    H, K = R.rwkv_head_pad(cfg), cfg.rwkv_head_size
    rng = np.random.default_rng(4)
    S0 = rng.normal(size=(B, H, K, K)).astype(np.float32)
    last = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    x = layer["x"][:, :1]
    want_y, want_st = JR.time_mix_decode(
        layer["tm"], layer["jcfg"], jnp.asarray(x),
        {"S": jnp.asarray(S0), "last": jnp.asarray(last)})
    state = {"S": torch.tensor(S0), "last": torch.tensor(last)}
    S_ptr = state["S"].data_ptr()
    y = R.time_mix_decode(layer["tm_t"], cfg, torch.tensor(x), state)
    _close(y, want_y, "float32")
    assert state["S"].data_ptr() == S_ptr
    _close(state["S"], want_st["S"], "float32")
    _close(state["last"], want_st["last"], "float32")


@pytest.mark.parametrize("with_last", [False, True])
def test_channel_mix(layer, with_last):
    x = layer["x"][:, :48]
    last = layer["x"][:, 100:101] if with_last else None
    want = JR.channel_mix(layer["cm"], jnp.asarray(x),
                          None if last is None else jnp.asarray(last))
    got = R.channel_mix(layer["cm_t"], torch.tensor(x),
                        None if last is None else torch.tensor(last))
    _close(got, want, "float32")


# ---------------------------------------------------------------------------
# the model on the smoke twin, reference params carried across
# ---------------------------------------------------------------------------

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


def test_carry_over_is_exact(lm):
    """Every leaf of the reference tree (ln0, the stacked time and channel
    mix, the norms' scale and bias), bit for bit, in the port's tree."""
    flat = jax.tree_util.tree_flatten_with_path(lm["jp"])[0]
    assert len(flat) == 31
    for path, leaf in flat:
        node = lm["p"]
        for key in path:
            node = node[key.key]
        assert node.dtype == (torch.float32 if leaf.dtype == np.float32
                              else DTYPES[lm["dtype"]])
        assert np.array_equal(node.float().numpy(),
                              np.asarray(leaf, np.float32))


@pytest.mark.parametrize("s", [PROMPT, 128])
def test_forward_logits(lm, s):
    tok = _tokens(lm["cfg"], (B, s), 1)
    want, _ = jax.jit(lm["jm"].forward)(lm["jp"], {"tokens": jnp.asarray(tok)})
    got, aux = lm["m"].forward(lm["p"], {"tokens": torch.tensor(tok)})
    assert got.shape == (B, s, lm["cfg"].padded_vocab())
    assert float(aux) == 0.0
    _close(got, want, lm["dtype"])


def test_prefill_step(lm):
    tok = _tokens(lm["cfg"], (B, PROMPT), 2)
    want = jax.jit(JS.make_prefill_step(lm["jm"]))(
        lm["jp"], {"tokens": jnp.asarray(tok)})
    got = S.make_prefill_step(lm["m"])(lm["p"], {"tokens": torch.tensor(tok)})
    assert got.shape == (B, lm["cfg"].padded_vocab())
    _close(got, want, lm["dtype"])


def _run_reference(lm, steps, start_tok, start=0, cache=None):
    """Reference greedy decode; returns (tokens (steps, b), cache)."""
    jc = cache if cache is not None else JS.init_cache(lm["jm"], B, 16)
    tok = jnp.asarray(start_tok)
    out = []
    for i in range(start, start + steps):
        tok, jc = lm["jdec"](lm["jp"], jc, tok, jnp.asarray(i, jnp.int32))
        out.append(np.asarray(tok))
    return np.stack(out), jc


def _close_state(cache, jc, dtype):
    for key in STATE:
        _close(cache["blocks"]["pos0"][key], jc["blocks"]["pos0"][key],
               dtype)


def test_decode_from_a_zero_state(lm):
    """8 greedy steps. f32: the port feeds itself and its tokens equal the
    reference's. bf16: both are fed the reference's tokens, and every
    step's greedy token agrees. Then the states (S, last, cm_last)."""
    dtype = lm["dtype"]
    want, jc = _run_reference(lm, 8, np.zeros((B, 1), np.int32))
    cache = S.init_cache(lm["m"], B, 16, device="cpu")
    H, K = R.rwkv_head_pad(lm["cfg"]), lm["cfg"].rwkv_head_size
    assert cache["blocks"]["pos0"]["S"].shape == (
        lm["cfg"].num_layers, B, H, K, K)
    dec = S.make_decode_step(lm["m"])
    tok = torch.zeros((B, 1), dtype=torch.int32)
    for i in range(8):
        if dtype == "bfloat16" and i:
            tok = torch.tensor(want[i - 1])
        tok, cache = dec(lm["p"], cache, tok, i)
        assert tok.dtype == torch.int32 and tok.shape == (B, 1)
        assert np.array_equal(tok.numpy(), want[i]), i
    _close_state(cache, jc, dtype)


def test_state_carried_across_mid_stream(lm):
    """3 reference steps, then the state and last token carried across:
    5 more steps in the port equal 5 more in the reference."""
    dtype = lm["dtype"]
    first, jc = _run_reference(lm, 3, np.zeros((B, 1), np.int32))
    cache = cache_from_reference(_np(jc), lm["cfg"], device="cpu")
    assert cache["blocks"]["pos0"]["S"].dtype == torch.float32
    want, jc = _run_reference(lm, 5, first[-1], start=3, cache=jc)
    dec = S.make_decode_step(lm["m"])
    tok = torch.tensor(first[-1])
    for j in range(5):
        if dtype == "bfloat16" and j:
            tok = torch.tensor(want[j - 1])
        tok, cache = dec(lm["p"], cache, tok, 3 + j)
        assert np.array_equal(tok.numpy(), want[j]), j
    _close_state(cache, jc, dtype)


def test_teacher_forced_decode_equals_prefill():
    """Decode over a 32-token prompt gives prefill's last logits (f32):
    within 32 tokens of a chunk start the clip does not bind at this
    init, so the chunked prefill and the exact decode agree (R3)."""
    lm = _setup("float32")
    tok = torch.tensor(_tokens(lm["cfg"], (B, 32), 5))
    want = S.make_prefill_step(lm["m"])(lm["p"], {"tokens": tok})
    cache = S.init_cache(lm["m"], B, 32, device="cpu")
    for i in range(32):
        got, cache = lm["m"].decode(lm["p"], cache, tok[:, i:i + 1], i)
    np.testing.assert_allclose(got[:, -1].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_serve_decode_on_the_cpu(capsys):
    """`serve_decode` on the (bf16) smoke twin with the reference's
    weights gives the reference serving loop's tokens; the RWKV state
    does not bound the steps."""
    lm = _setup("bfloat16")
    steps = 6
    run = serve.serve_decode(ARCH, steps, B, 4, smoke=True, device="cpu",
                             params=lm["p"])
    assert "tok/s" in capsys.readouterr().out
    assert run.tokens.shape == (B, steps) and run.step_ms is None
    want, _ = _run_reference(lm, steps, np.zeros((B, 1), np.int32))
    assert np.array_equal(run.tokens.numpy(), want[:, :, 0].T)


def test_serve_cli(capsys):
    serve.main(["--mode", "decode", "--arch", ARCH, "--smoke", "--device",
                "cpu", "--steps", "3", "--batch", "2", "--cache-len", "1"])
    assert "3 steps x batch 2" in capsys.readouterr().out
