"""Decode on a mesh, the cache in the reference's blocks (the "kv_seq",
"long_kv_seq" and "act_heads" rules), on the CPU (gloo ranks through
tests/torch_ranks.py) against one process:

  * (g) eight ranks at (4, 2) prefill, teacher-force a prompt into the
    cache and decode 8 greedy steps of the f32 twins of tinyllama (dense,
    GQA: the cache over its rows on "model", each rank's partial output
    combined by its logsumexp), qwen1.5 (MHA padded from 4 to 6 heads,
    the f8 cache over its heads: no combine), llama4-scout (moe), rwkv6
    (ssm: the state on the rank's heads) and jamba (hybrid: the mamba
    state on its d_inner block). Tokens equal, logits and the prefill's
    vocab block within 1e-5, and each rank's block of every cache and
    state leaf equal to that block of the one-process cache (an f8 byte
    may be its neighbouring code);
  * (h) the long-context rule: a batch-1 dense twin whose cache rows are
    split over ("data", "model"), eight blocks, equals one process;
  * (i) the plain decode version's (out, lse) over a cache's blocks,
    combined, equals the reference's whole `layers.decode_attention`
    within 1e-6;
  * (j) the audio family: whisper's twin (4/4 heads, unpadded: the self
    cache over its rows, the cross cache whole over its heads) at (4, 2),
    and a padded variant (6/6 heads padded to 8: both caches over the
    padded heads) at (4, 2), where "model" splits its heads, and at
    (2, 4), where it does not; the cross cache filled from `encode` and
    `encode_kv` (`fill_cross_cache`) on the mesh and in one process, the
    prefill over `frames` and the prompt; the same limits as (g)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ranks import Ranks                               # noqa: E402

TIMEOUT = 300
TOL = 1e-5
PADDED = dict(num_heads=6, num_kv_heads=6, head_pad_to=8)
B, PROMPT, STEPS, CACHE = 8, 4, 8, 16
CASES = {"dense": ("tinyllama-1.1b", {}),
         "mha": ("qwen1.5-32b", dict(num_kv_heads=4, head_pad_to=6,
                                      kv_cache_dtype="float8_e4m3fn")),
         "moe": ("llama4-scout-17b-a16e", {}),
         "ssm": ("rwkv6-3b", {}),
         "hybrid": ("jamba-v0.1-52b", {}),
         "audio": ("whisper-tiny", {}),
         "audio_pad": ("whisper-tiny", PADDED),
         "audio_pad_2x4": ("whisper-tiny", PADDED)}
# the mesh of each case: (4, 2) but where named
SHAPE = {"audio_pad_2x4": (2, 4)}

COMMON = f"""
import dataclasses
import numpy as np
import torch
from repro_torch.configs import smoke_config
from repro_torch.models import build
from repro_torch.models.params import init_params
from repro_torch.models.steps import init_cache, make_prefill_step
from repro_torch.models import layers

CASES = {CASES!r}
B, PROMPT, STEPS, CACHE = {B}, {PROMPT}, {STEPS}, {CACHE}
SHAPE = {SHAPE!r}


def twin(case):
    arch, extra = CASES[case]
    return build(dataclasses.replace(smoke_config(arch), dtype="float32",
                                     param_dtype="float32", **extra))


def prompt(mdl, batch):
    rng = np.random.default_rng(7)
    return torch.tensor(rng.integers(0, mdl.cfg.vocab_size,
                                     (batch, PROMPT)), dtype=torch.int32)


def leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k],
                                                         path + "/" + k)]
    return [(path, tree.detach().view(torch.uint8).numpy().copy()
             if tree.dtype == torch.float8_e4m3fn
             else tree.detach().numpy().copy())]


def frames(mdl, batch):
    rng = np.random.default_rng(11)
    return torch.tensor(rng.normal(size=(batch, mdl.cfg.encoder_seq_len,
                                         mdl.cfg.d_model)),
                        dtype=torch.float32)


def run(mdl, batch, mesh=None, long_ctx=False, rows=slice(None)):
    # prefill logits of the prompt, then the prompt teacher-forced into
    # the cache and STEPS greedy steps; the logits of every step; the
    # audio family's cross cache filled from its frames first
    torch.manual_seed(0)
    params = init_params(mdl.param_tree, 0, "cpu", mesh)
    cache = init_cache(mdl, batch, CACHE, "cpu", long_ctx=long_ctx,
                       mesh=mesh)
    toks = prompt(mdl, batch)[rows]
    spec = None
    if mesh is not None:
        spec = layers.cache_spec(mdl.cfg, batch, CACHE, mesh, long_ctx)
    inputs = {{"tokens": toks}}
    with torch.no_grad():
        if mdl.cfg.family == "audio":
            inputs["frames"] = frames(mdl, batch)[rows]
            ctx = mesh if mesh is not None else torch.no_grad()
            with ctx:
                mdl.fill_cross_cache(params, cache, inputs["frames"], spec)
        pre = make_prefill_step(mdl, mesh)(params, inputs)
        logits, out = [], []
        tok = toks[:, :1]
        for i in range(PROMPT + STEPS):
            ctx = mesh if mesh is not None else torch.no_grad()
            with ctx:
                lg, cache = mdl.decode(params, cache, tok, i, spec)
            logits.append(lg[:, -1].numpy().copy())
            nxt = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            tok = toks[:, i + 1:i + 2] if i + 1 < PROMPT else nxt
            out.append(nxt.numpy().copy())
    return dict(prefill=pre.numpy().copy(), logits=np.stack(logits),
                tokens=np.stack(out), cache=leaves(cache))
"""

EIGHT = COMMON + """
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import row_block
meshes = {shape: mesh_lib.make_mesh(shape, ("data", "model"))
          for shape in ((4, 2), (2, 4))}
m42 = meshes[(4, 2)]
OUT["coords"] = {shape: m.coords for shape, m in meshes.items()}
for case in CASES:
    m = meshes[SHAPE.get(case, (4, 2))]
    mesh_lib.CALLS.clear()
    OUT[case] = run(twin(case), B, m, rows=row_block(m, B))
    OUT[case]["calls"] = dict(mesh_lib.CALLS)
mesh_lib.CALLS.clear()
OUT["long"] = run(twin("dense"), 1, m42, long_ctx=True)
OUT["long"]["calls"] = dict(mesh_lib.CALLS)
"""


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_decode")
    return Ranks(d, 8, code=EIGHT).result(TIMEOUT)


@pytest.fixture(scope="module")
def one():
    ns = {}
    exec(COMMON, ns)
    out = {case: ns["run"](ns["twin"](case), B) for case in CASES}
    out["long"] = ns["run"](ns["twin"]("dense"), 1)
    out["_twin"] = ns["twin"]
    return out


def _blocks(mdl, batch, coords, long_ctx, shape=(4, 2)):
    """The rank's block slices of every cache leaf (sorted paths), by the
    reference's rules on the mesh of `shape`, with the one-process leaf
    padded to the mesh layout's heads."""
    import types
    from repro_torch.models.params import (LOGICAL_RULES_TP, block_slices,
                                           resolve_axes)
    axes = ("data", "model")
    m = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape),
                              shape=dict(zip(axes, shape)), coords=coords)
    specs = mdl.cache_specs(batch, CACHE, long_ctx, padded=True)

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in walk(tree[k],
                                                          path + "/" + k)]
        spec = resolve_axes(tree.axes, tree.shape, m, LOGICAL_RULES_TP)
        return [(path, tree.shape, block_slices(tree.shape, spec, m))]
    return walk(specs)


def _pad_heads(a, shape):
    """The one-process k/v leaf with zero heads to the mesh layout's."""
    if a.shape == tuple(shape):
        return a
    out = np.zeros(shape, a.dtype)
    out[..., :a.shape[-2], :] = a
    return out


def _same_cache(case, got, want, blocks):
    for (path, g), (_, w), (_, shape, sl) in zip(got, want, blocks):
        w = _pad_heads(w, shape)[sl]
        assert g.shape == w.shape, (case, path, g.shape, w.shape)
        if g.dtype == np.uint8:          # f8 codes: equal or neighbours
            diff = np.abs(g.astype(np.int16) - w.astype(np.int16))
            assert diff.max(initial=0) <= 1, (case, path)
            assert (diff == 0).mean() > 0.99, (case, path)
        else:
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                       err_msg=f"{case} {path}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_on_the_mesh_equals_one_process(eight, one, case):
    """(g) and (j): tokens, logits, the prefill's vocab block and every
    rank's cache block against one process."""
    mdl = one["_twin"](case)
    vp = mdl.cfg.padded_vocab()
    shape = SHAPE.get(case, (4, 2))
    n_rows, n_cols = B // shape[0], vp // shape[1]
    for r, out in enumerate(eight):
        got, want = out[case], one[case]
        coords = out["coords"][shape]
        rows = slice(coords["data"] * n_rows, (coords["data"] + 1) * n_rows)
        assert np.array_equal(got["tokens"], want["tokens"][:, rows]), r
        np.testing.assert_allclose(got["logits"], want["logits"][:, rows],
                                   rtol=TOL, atol=TOL)
        cols = slice(coords["model"] * n_cols, (coords["model"] + 1)
                     * n_cols)
        np.testing.assert_allclose(got["prefill"],
                                   want["prefill"][rows, cols],
                                   rtol=TOL, atol=TOL)
        _same_cache(case, got["cache"], want["cache"],
                    _blocks(mdl, B, coords, False, shape))
    if mdl.cfg.family == "audio":       # the cross cache was filled
        cross = dict(one[case]["cache"])["/dec/cross/k"]
        assert (np.abs(cross).max(axis=(0, 1, 2, 4)) > 0).all()


def test_the_combine_and_the_head_split_talk_as_designed(eight):
    """The GQA cache combines over "model" (a max and a sum a layer and
    step), and so does the whisper twin's self cache; the MHA-padded
    caches need no combine: only the row-parallel sums over "model"."""
    steps = PROMPT + STEPS
    for out in eight:
        dense = out["dense"]["calls"]
        assert dense[(("model",), "max")] == 4 * steps
        mha = out["mha"]["calls"]
        assert (("model",), "max") not in mha
        audio = out["audio"]["calls"]        # the self cache's rows
        assert audio[(("model",), "max")] == 2 * steps
        for case in ("audio_pad", "audio_pad_2x4"):
            assert (("model",), "max") not in out[case]["calls"]
            assert out[case]["calls"][(("model",), "sum")] > 0
        long = out["long"]["calls"]
        assert long[(("data", "model"), "max")] == 4 * steps
        assert long[(("data", "model"), "sum")] == 4 * steps


def test_long_context_cache_equals_one_process(eight, one):
    """(h): batch 1, the cache's rows over ("data", "model")."""
    mdl = one["_twin"]("dense")
    for out in eight:
        got, want = out["long"], one["long"]
        assert np.array_equal(got["tokens"], want["tokens"])
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=TOL,
                                   atol=TOL)
        _same_cache("long", got["cache"], want["cache"],
                    _blocks(mdl, 1, out["coords"][(4, 2)], True))


def test_blocks_combined_equal_the_reference_decode_attention():
    """(i): `decode_attention_block_ref` over four blocks of a cache,
    combined by `combine_blocks_ref`, against the reference's whole
    `layers.decode_attention` (its attention, from q, k and v), 1e-6."""
    import jax.numpy as jnp
    from repro.configs import smoke_config as jax_smoke
    from repro.models import build as jax_build
    from repro.models import layers as JL
    from repro.models.params import init_params as jax_init
    from repro_torch.kernels.decode_attention.ref import (
        combine_blocks_ref, decode_attention_block_ref)
    cfg = dataclasses.replace(jax_smoke("tinyllama-1.1b"), dtype="float32",
                              param_dtype="float32")
    p = jax_init(JL.attention_params(cfg), 0)
    eye = {k: np.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(3)
    b, S, nkv, hd = 3, 32, cfg.num_kv_heads, cfg.head_dim
    ck = rng.normal(size=(b, S, nkv, hd)).astype(np.float32)
    cv = rng.normal(size=(b, S, nkv, hd)).astype(np.float32)
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    for index in (0, 5, 17, 31):
        y, jk, jv = JL.decode_attention(
            p, cfg, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), index)
        # q as the reference forms it, the cache after its write
        pos = jnp.full((b, 1), index, jnp.int32)
        q, _, _ = JL.project_qkv(p, cfg, jnp.asarray(x), pos)
        q = torch.tensor(np.asarray(q)).reshape(b, nkv, -1, hd)
        K, V = torch.tensor(np.asarray(jk)), torch.tensor(np.asarray(jv))
        parts = [decode_attention_block_ref(q, K[:, r:r + 8], V[:, r:r + 8],
                                            index, r)
                 for r in range(0, S, 8)]
        out = combine_blocks_ref(parts).reshape(b, 1, -1, hd)
        got = torch.einsum("bshk,hkd->bsd", out,
                           torch.tensor(eye["wo"])).numpy()
        np.testing.assert_allclose(got, np.asarray(y), rtol=1e-6, atol=1e-6)
        if index < 24:                   # blocks after the index: nothing
            o, lse = parts[-1]
            assert torch.all(o == 0) and torch.all(lse == float("-inf"))
