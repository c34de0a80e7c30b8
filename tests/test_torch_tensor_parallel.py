"""The train state held in blocks over a ("data", "model") mesh, on the
CPU (gloo ranks through tests/torch_ranks.py), against one process:

  * one eight-rank launch steps the f32 smoke twins of every family at
    (4, 2): tinyllama (dense), pixtral (vlm, image embeddings in front),
    llama4-scout and dbrx (moe; dbrx with 2 microbatches), rwkv6 (ssm),
    jamba (hybrid) and whisper (audio: frames, the encoder, cross-
    attention), and a padded variant of whisper's twin (6/6 heads padded
    to 8) at (4, 2), where "model" splits its heads, and at (2, 4), where
    they compute whole, and the tinyllama twin on 15 positions, which
    "model" does not divide; each rank holds the local shapes of
    `train_state_specs`, and its blocks after one step, the loss, metrics
    and grad_norm equal the one-process step's (1e-4 for the state, 1e-5
    for the metrics, and each moment leaf's block, which carries the
    step's gradient, within 1e-5 of its norm); `CALLS` shows the sums
    over "model"; the tinyllama twin again at (8, 1) shows none over
    "model";
  * the residual stream (the reference's `seq_sp` rule): under remat
    "full" each layer's checkpoint keeps SEQ / "model" positions of the
    stream where "model" divides the sequence, all 15 where it does not;
    the reduce-scatters over "model" are those the layer plan predicts;
  * F6: one MoE layer's aux over 4 row shards is the global batch's, for
    a state held whole and for one held in blocks, and the MoE twins'
    aux gradient (the router's, averaged over the rows) is the one
    process's;
  * checkpoints: the tinyllama state saved at (4, 2) is byte for byte a
    one-process save of the gathered state and opens in the reference; a
    four-rank launch restores it at (2, 2) (`make_elastic_mesh`) and its
    next step equals the eight ranks' next step;
  * a reference-layout state carried onto the mesh keeps the rank's
    blocks."""
import dataclasses
import filecmp
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402

from torch_ranks import Ranks                               # noqa: E402

TIMEOUT = 300
# ‖got − want‖ ≤ GRAD_RTOL · ‖want‖ for each block of m (2 · GRAD_RTOL
# for v, whose relative error is twice the gradient's): at the step's
# first rate (3e-6) the params move below the elementwise 1e-4, and
# m = 0.1 · g and v = 0.05 · g² are of its size or smaller, so the
# gradient is held by the moments' relative error
GRAD_RTOL = 1e-5
BATCH, SEQ = 8, 16
IMAGES = 8                      # the vlm twin's image embeddings
CASES = {"dense": ("tinyllama-1.1b", 1), "vlm": ("pixtral-12b", 1),
         "moe": ("llama4-scout-17b-a16e", 1), "moe_mb2": ("dbrx-132b", 2),
         "ssm": ("rwkv6-3b", 1), "hybrid": ("jamba-v0.1-52b", 1),
         "audio": ("whisper-tiny", 1), "audio_pad": ("whisper-tiny", 1),
         "audio_pad_2x4": ("whisper-tiny", 1),
         "dense_seq15": ("tinyllama-1.1b", 1)}
# config changes of a case, its mesh where it is not (4, 2), and its
# sequence where it is not SEQ
EXTRA = {"audio_pad": dict(num_heads=6, num_kv_heads=6, head_pad_to=8)}
EXTRA["audio_pad_2x4"] = EXTRA["audio_pad"]
SHAPE = {"audio_pad_2x4": (2, 4)}
SEQ_OF = {"dense_seq15": 15}
MOE_CASES = ("moe", "moe_mb2")
ROUTER = ("params", "blocks", "pos0", "moe", "router")

COMMON = f"""
import dataclasses
from repro_torch.configs import smoke_config
from repro_torch.data import TokenStream
from repro_torch.models import build

CASES = {CASES!r}
EXTRA = {EXTRA!r}
SHAPE = {SHAPE!r}
SEQ, SEQ_OF = {SEQ}, {SEQ_OF!r}

def twin(case):
    arch, mb = CASES[case]
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                              param_dtype="float32", microbatches=mb,
                              remat_policy="full", **EXTRA.get(case, {{}}))
    return build(cfg)

def batch(mdl, i, seq=SEQ):
    cfg = mdl.cfg
    ds = TokenStream(vocab_size=cfg.vocab_size, batch={BATCH},
                     seq_len=seq, seed=0)
    out = {{k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}}
    if cfg.family == "vlm":
        rng = np.random.default_rng(100 + i)
        out["img_embeds"] = torch.tensor(rng.normal(
            size=({BATCH}, {IMAGES}, cfg.d_model)), dtype=torch.float32)
    if cfg.family == "audio":
        rng = np.random.default_rng(200 + i)
        out["frames"] = torch.tensor(rng.normal(
            size=({BATCH}, cfg.encoder_seq_len, cfg.d_model)),
            dtype=torch.float32)
    return out

def leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k],
                                                         path + "/" + k)]
    return [(path, tree.detach().numpy().copy())]
"""

EIGHT = COMMON + """
from repro_torch.checkpoint import AsyncCheckpointer, save_checkpoint
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import row_block
from repro_torch.models import moe
from repro_torch.models import transformer
from repro_torch.models.params import (init_params, partition_specs, shard,
                                       sharded_axes)
from repro_torch.models.steps import (_sharded_mean, init_train_state,
                                      make_train_step, train_state_specs)
from repro_torch.optim import tree_leaves
m42 = mesh_lib.make_mesh((4, 2), ("data", "model"))
m24 = mesh_lib.make_mesh((2, 4), ("data", "model"))
m81 = mesh_lib.make_mesh((8, 1), ("data", "model"))
OUT["coords"] = m42.coords
OUT["coords24"] = m24.coords

# the residual input each layer's checkpoint keeps (its second argument:
# `_layer_apply`'s and `_dec_layer_apply`'s x), its positions a rank
SAVED = []
_checkpoint = transformer.checkpoint

def recording_checkpoint(fn, *args, **kw):
    SAVED.append(tuple(args[1].shape))
    return _checkpoint(fn, *args, **kw)

transformer.checkpoint = recording_checkpoint

def step_case(case, mesh):
    mdl = twin(case)
    state = init_train_state(mdl, device="cpu", mesh=mesh)
    specs = train_state_specs(mdl, mesh)
    local_ok = all(tuple(t.shape) == tuple(s.local.shape) for t, s in zip(
        tree_leaves(state), tree_leaves(specs)))
    mesh_lib.CALLS.clear()
    SAVED.clear()
    state, met = make_train_step(mdl, mesh=mesh)(
        state, batch(mdl, 0, SEQ_OF.get(case, SEQ)))
    return mdl, state, specs, dict(
        metrics={k: float(v) for k, v in met.items()},
        calls=dict(mesh_lib.CALLS), local_ok=local_ok, state=leaves(state),
        saved=list(SAVED))

for case in CASES:
    mesh = m24 if SHAPE.get(case) == (2, 4) else m42
    mdl, state, specs, OUT[case] = step_case(case, mesh)
    if case in MOE:
        # the aux's gradient of the router, averaged over the row shards
        params = state["params"]
        router = params["blocks"]["pos0"]["moe"]["router"]
        b = batch(mdl, 1)
        with m42:
            rows = {k: x[row_block(m42, x.shape[0])] for k, x in b.items()}
            _, aux = mdl.forward(params, rows, return_hidden=True)
            g, = torch.autograd.grad(aux, router)
        spec = specs["params"]["blocks"]["pos0"]["moe"]["router"].spec
        (g,), aux, _ = _sharded_mean(m42, [g], [sharded_axes(spec)], aux, {})
        OUT[case]["aux_grad"] = dict(aux=float(aux), grad=g.numpy())
    if case == "dense":
        save_checkpoint(os.environ["RANKS_CKPT"], state, 1, specs=specs)
        saver = AsyncCheckpointer(os.environ["RANKS_CKPT"] + "_async",
                                  specs=specs)
        saver.save(state, 1)
        saver.wait()
        saver.close()
        state, met = make_train_step(mdl, mesh=m42)(state, batch(mdl, 1))
        OUT["next_loss"] = float(met["loss"])
    if case == "audio":
        save_checkpoint(os.environ["RANKS_CKPT"] + "_audio", state, 1,
                        specs=specs)
_, _, _, OUT["dense_8x1"] = step_case("dense", m81)
m222 = mesh_lib.make_mesh((2, 2, 2), ("pod", "data", "model"))
_, _, _, OUT["dense_pod"] = step_case("dense", m222)
OUT["pod_coords"] = m222.coords

# F6 on the data-parallel path: a whole state, 2 microbatches
mdl = twin("moe_mb2")
state = init_train_state(mdl, device="cpu")
state, met = make_train_step(mdl, mesh=m42)(state, batch(mdl, 0))
OUT["moe_mb2_whole"] = dict(metrics={k: float(v) for k, v in met.items()},
                            state=leaves(state))

# F6: one MoE layer over 4 row shards, whole and in blocks
mdl = twin("moe")
cfg = mdl.cfg
tree = moe.moe_params(cfg)
p = init_params(tree, 7, "cpu")
x = torch.tensor(np.random.default_rng(5).normal(size=(8, 16, cfg.d_model)),
                 dtype=torch.float32)
xr = x[row_block(m42, 8)]
with m42.replicated():
    _, OUT["layer_aux_whole"] = moe.moe(p, cfg, xr)
def cut(v, spec):
    if isinstance(v, dict):
        return {k: cut(v[k], spec[k]) for k in v}
    return shard(v, spec, m42)
blocks = cut(p, partition_specs(tree, m42))
with m42:
    y, OUT["layer_aux_blocks"] = moe.moe(blocks, cfg, xr)
OUT["layer_y"] = y.detach().numpy()
OUT["layer_aux_local"] = float(moe.moe(p, cfg, xr)[1])

# a reference-layout state (numpy leaves) carried onto the mesh
from repro_torch.core.convert import train_state_from_reference
def as_numpy(t):
    if isinstance(t, dict):
        return {k: as_numpy(v) for k, v in t.items()}
    return t.detach().numpy()
OUT["convert"] = {}
for case in ("hybrid", "audio"):
    mdl = twin(case)
    whole = init_train_state(mdl, device="cpu")
    got = train_state_from_reference(as_numpy(whole), mdl.cfg,
                                     device="cpu", mesh=m42)
    want = init_train_state(mdl, device="cpu", mesh=m42)
    OUT["convert"][case] = [
        (tuple(a.shape), torch.equal(a, b), a.requires_grad)
        for a, b in zip(tree_leaves(got), tree_leaves(want))]

""".replace("MOE", repr(MOE_CASES))

FOUR = COMMON + """
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.models.steps import make_train_step, train_state_specs
mesh4 = make_elastic_mesh(4, model_parallel=2)
mdl = twin("dense")
state, at = restore_checkpoint(os.environ["RANKS_CKPT"],
                               train_state_specs(mdl, mesh4), device="cpu")
OUT["shapes"] = [tuple(t.shape) for _, t in leaves(state)]
state, m = make_train_step(mdl, mesh=mesh4)(state, batch(mdl, at))
OUT.update(shape=mesh4.shape, at=at, loss=float(m["loss"]))
"""


def _twin(case):
    from repro_torch.configs import smoke_config
    from repro_torch.models import build
    arch, mb = CASES[case]
    return build(dataclasses.replace(smoke_config(arch), dtype="float32",
                                     param_dtype="float32", microbatches=mb,
                                     remat_policy="full",
                                     **EXTRA.get(case, {})))


def _batch(mdl, i, seq=SEQ):
    from repro_torch.data import TokenStream
    cfg = mdl.cfg
    ds = TokenStream(vocab_size=cfg.vocab_size, batch=BATCH, seq_len=seq,
                     seed=0)
    out = {k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}
    if cfg.family == "vlm":
        rng = np.random.default_rng(100 + i)
        out["img_embeds"] = torch.tensor(rng.normal(
            size=(BATCH, IMAGES, cfg.d_model)), dtype=torch.float32)
    if cfg.family == "audio":
        rng = np.random.default_rng(200 + i)
        out["frames"] = torch.tensor(rng.normal(
            size=(BATCH, cfg.encoder_seq_len, cfg.d_model)),
            dtype=torch.float32)
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                          f"{path}/{k}")]
    return [(path, tree)]


def _one_process():
    """One step of every case in this process on the global batch (and a
    second for the dense twin), the aux gradients and the F6 layer."""
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    from repro_torch.models.steps import init_train_state, make_train_step
    torch.set_num_threads(1)
    out = {}
    for case in CASES:
        mdl = _twin(case)
        state = init_train_state(mdl, device="cpu")
        step = make_train_step(mdl)
        state, met = step(state, _batch(mdl, 0, SEQ_OF.get(case, SEQ)))
        out[case] = dict(metrics={k: float(v) for k, v in met.items()},
                         state=[(p, t.detach().numpy().copy())
                                for p, t in _leaves(state)], mdl=mdl)
        if case in MOE_CASES:
            params = state["params"]
            router = params["blocks"]["pos0"]["moe"]["router"]
            _, aux = mdl.forward(params, _batch(mdl, 1), return_hidden=True)
            g, = torch.autograd.grad(aux, router)
            out[case]["aux_grad"] = dict(aux=float(aux.detach()),
                                         grad=g.numpy())
        if case == "dense":
            state, met = step(state, _batch(mdl, 1))
            out["next_loss"] = float(met["loss"])
    cfg = _twin("moe").cfg
    p = init_params(moe.moe_params(cfg), 7, "cpu")
    x = torch.tensor(np.random.default_rng(5).normal(
        size=(8, 16, cfg.d_model)), dtype=torch.float32)
    y, aux = moe.moe(p, cfg, x)
    out["layer"] = dict(y=y.detach().numpy(), aux=float(aux))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    ckpt = str(tmp / "ckpt")
    eight = Ranks(tmp / "eight", 8, code=EIGHT, env={"RANKS_CKPT": ckpt})
    four = None
    try:
        one = _one_process()
        outs = eight.result(TIMEOUT)
        four = Ranks(tmp / "four", 4, code=FOUR, env={"RANKS_CKPT": ckpt})
        return dict(eight=outs, four=four.result(TIMEOUT), one=one,
                    ckpt=ckpt, tmp=tmp)
    finally:
        for job in (eight, four):
            if job is not None:
                job.kill()


def _mesh(coords, shape=(4, 2), axes=("data", "model")):
    return types.SimpleNamespace(
        axis_names=axes, devices=np.empty(shape),
        shape=dict(zip(axes, shape)), coords=coords)


def _case_mesh(out, case):
    """A rank's mesh of `case` (its coordinates from `out`)."""
    if SHAPE.get(case) == (2, 4):
        return _mesh(out["coords24"], (2, 4))
    return _mesh(out["coords"])


def _assert_moment(path, got, want):
    """A block of m or v (the step's gradient) within GRAD_RTOL of its
    norm (v: twice that); other leaves pass through."""
    if not path.startswith(("/opt/m/", "/opt/v/")):
        return
    rtol = GRAD_RTOL * (2 if path.startswith("/opt/v/") else 1)
    err = np.linalg.norm((got - want).astype(np.float64).ravel())
    ref = np.linalg.norm(want.astype(np.float64).ravel())
    assert err <= rtol * ref, f"{path}: ‖err‖ {err:.3e}, ‖want‖ {ref:.3e}"


def _blocks(mdl, mesh):
    """The block slices of every state leaf on `mesh`, in `_leaves`
    order."""
    from repro_torch.models.steps import train_state_specs
    return [sh.slices for _, sh in _leaves(train_state_specs(mdl, mesh))]


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", range(8))
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_equals_one_process(run, case, rank):
    out, one = run["eight"][rank], run["one"][case]
    got = out[case]
    assert got["local_ok"]
    for k, want in one["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], want, rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    slices = _blocks(one["mdl"], _case_mesh(out, case))
    assert [p for p, _ in got["state"]] == [p for p, _ in one["state"]]
    shrunk = 0
    for (path, g), (_, w), sl in zip(got["state"], one["state"], slices):
        assert g.shape == w[sl].shape, path
        shrunk += g.size < w.size
        np.testing.assert_allclose(g, w[sl], rtol=1e-4, atol=1e-4,
                                   err_msg=path)
        _assert_moment(path, g, w[sl])
    assert shrunk > len(slices) // 2          # most leaves are blocks


@pytest.mark.parametrize("case", sorted(CASES))
def test_moment_check_fails_an_unchanged_state(run, case):
    """The control of the moments' check: a step that left the state as
    it was (m and v still zero) fails it on every leaf with a gradient."""
    failed = total = 0
    for path, w in run["one"][case]["state"]:
        if path.startswith("/opt/m/") and np.any(w):
            total += 1
            with pytest.raises(AssertionError):
                _assert_moment(path, np.zeros_like(w), w)
            failed += 1
    assert total > 0 and failed == total


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_state_gathers_to_one_process(run, case):
    """The eight ranks' blocks put together are the whole state, every
    element covered by its owners alike."""
    one = run["one"][case]
    slices = [_blocks(one["mdl"], _case_mesh(o, case))
              for o in run["eight"]]
    for i, (path, w) in enumerate(one["state"]):
        whole = np.full(w.shape, np.nan, np.float64)
        for r, o in enumerate(run["eight"]):
            blk = o[case]["state"][i][1]
            prev = whole[slices[r][i]]
            assert np.isnan(prev).all() or np.array_equal(prev, blk), path
            whole[slices[r][i]] = blk
        assert not np.isnan(whole).any(), path
        np.testing.assert_allclose(whole, w, rtol=1e-4, atol=1e-4,
                                   err_msg=path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_axis_talks_only_where_it_splits(run, case):
    for o in run["eight"]:
        calls = o[case]["calls"]
        assert calls.get((("model",), "sum"), 0) > 0, calls
        assert calls.get((("data",), "reduce_scatter"), 0) > 0, calls
        assert calls.get((("model",), "max"), 0) > 0, calls
    for o in run["eight"]:
        calls = o["dense_8x1"]["calls"]
        assert not any("model" in axes for axes, _ in calls), calls
        assert calls.get((("data",), "all_gather"), 0) > 0, calls
        for k, want in run["one"]["dense"]["metrics"].items():
            np.testing.assert_allclose(o["dense_8x1"]["metrics"][k], want,
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def _positions(case, shape):
    """The stream's positions a rank: the sequence (the vlm twin's image
    embeddings in front) over "model" where "model" divides it (the
    reference's `seq_sp` rule), else all of it."""
    seq = SEQ_OF.get(case, SEQ) + (IMAGES if CASES[case][0] == "pixtral-12b"
                                   else 0)
    return seq // shape[1] if seq % shape[1] == 0 else seq


def _model_scatters(case, shape):
    """The reduce-scatters over "model" of one step of `case` on `shape`,
    by its layer plan. A tensor-parallel sublayer on a split stream
    reduce-scatters its output (the exit) in the forward, again in remat's
    second forward but for a layer's last sublayer (torch's checkpoint
    stops recomputing once the tensors the backward reads are back), and
    its gathered input's gradient (the entry) in the backward; a
    sublayer that needs every position or computes whole (the MoE, the
    RWKV channel mix; the time mix's entry) cuts its output and takes the
    rank's block of the gradient, which sends nothing. Besides, each k and
    v gathered over "model" (`kv_head_dim`) and mamba's `in_proj` give one
    in the backward on any stream, and on a split stream the embedding's
    sum, the final hidden state's gather and the encoder output's gather
    one each. Every count is per microbatch."""
    from repro_torch.models.rwkv6 import rwkv_head_pad
    from repro_torch.models.transformer import _layer_plan
    cfg = _twin(case).cfg
    m = shape[1]
    stream = _positions(case, shape) != SEQ_OF.get(case, SEQ) + (
        IMAGES if cfg.family == "vlm" else 0)

    def on(n):
        return n % m == 0
    heads = on(cfg.num_heads)
    kv = 2 if heads and not cfg.mha_padded and on(cfg.head_dim) else 0
    # (exit, entry, weight gathers) of each sublayer
    cost = {"attn": (stream * heads, stream * heads, kv),
            "cross": (stream * heads, stream * heads, 0),
            "mlp": (stream * on(cfg.d_ff),) * 2 + (0,),
            "mamba": (stream * on(cfg.mamba_d_inner),) * 2 + (1,),
            "rwkv": (stream * on(rwkv_head_pad(cfg)), 0, 0),
            "moe": (0, 0, 0), "rwkv_cm": (0, 0, 0)}

    def layer(subs, remat=True):
        n = 0
        for i, sub in enumerate(subs):
            out, back, weights = cost[sub]
            n += out * (1 + (remat and i < len(subs) - 1)) + back + weights
        return n
    ends = 2 * (stream and on(cfg.padded_vocab()))    # embedding, head
    if cfg.family == "vlm":
        ends //= 2              # the embeddings put together whole, then cut
    if cfg.family == "audio":
        enc = on(cfg.encoder_seq_len)
        stream, full = enc, stream
        n = cfg.num_encoder_layers * layer(["attn", "mlp"], remat=False)
        stream = full
        n += cfg.num_layers * (layer(["attn", "cross", "mlp"]) + kv)
        return n + ends + enc * heads
    plan, blocks = _layer_plan(cfg)
    ffn = {"dense": "mlp"}
    n = blocks * sum(layer([k, ffn.get(f, f)]) for k, f in plan)
    return cfg.microbatches * (n + ends)


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_layer_keeps_its_ranks_positions_of_the_stream(run, case):
    """Under remat "full" each layer's checkpoint keeps its input, the
    residual stream: SEQ / "model" positions a rank (the reference's
    `seq_sp` rule) where "model" divides the sequence, every position of
    dense_seq15's 15; one checkpoint a layer and microbatch."""
    shape = SHAPE.get(case, (4, 2))
    cfg = _twin(case).cfg
    want = (BATCH // (cfg.microbatches * shape[0]), _positions(case, shape),
            cfg.d_model)
    for o in run["eight"]:
        saved = o[case]["saved"]
        assert len(saved) == cfg.microbatches * cfg.num_layers
        assert set(saved) == {want}, saved
    assert (_positions(case, shape) == 15) == (case == "dense_seq15")


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_reduce_scatters_are_the_layer_plans(run, case):
    want = _model_scatters(case, SHAPE.get(case, (4, 2)))
    for o in run["eight"]:
        got = o[case]["calls"].get((("model",), "reduce_scatter"), 0)
        assert got == want, (got, want)


@pytest.mark.parametrize("rank", range(8))
def test_pod_mesh_step_equals_one_process(run, rank):
    """At (2, 2, 2) over ("pod", "data", "model") the blocks sharded over
    "data" are summed over "pod" too: the step is the one process's."""
    out, one = run["eight"][rank], run["one"]["dense"]
    got = out["dense_pod"]
    assert got["local_ok"]
    for k, want in one["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], want, rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    slices = _blocks(one["mdl"], _mesh(out["pod_coords"], (2, 2, 2),
                                       ("pod", "data", "model")))
    for (path, g), (_, w), sl in zip(got["state"], one["state"], slices):
        np.testing.assert_allclose(g, w[sl], rtol=1e-4, atol=1e-4,
                                   err_msg=path)
        _assert_moment(path, g, w[sl])
    assert got["calls"].get((("pod",), "sum"), 0) > 0, got["calls"]


# ---------------------------------------------------------------------------
# F6: the MoE aux loss over the global batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", range(8))
def test_data_parallel_moe_microbatches_equal_one_process(run, rank):
    """A state held whole on every rank (the data-parallel path), dbrx's
    twin with 2 microbatches: microbatch i is the global batch's block i
    and the aux is the global one, so the step is the one process's."""
    got, one = run["eight"][rank]["moe_mb2_whole"], run["one"]["moe_mb2"]
    for k, want in one["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], want, rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for (path, g), (_, w) in zip(got["state"], one["state"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=path)
        _assert_moment(path, g, w)


def test_moe_layer_aux_is_the_global_batch(run):
    """One MoE layer over 4 row shards: the aux is the global batch's
    (one process on all 8 rows), not the rank's own rows', whether the
    state is whole on every rank or in blocks; the blocks' output equals
    the one process's rows."""
    want = run["one"]["layer"]
    locals_ = set()
    for r, o in enumerate(run["eight"]):
        np.testing.assert_allclose(float(o["layer_aux_whole"]), want["aux"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(o["layer_aux_blocks"]),
                                   want["aux"], rtol=1e-6, atol=1e-6)
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)
        np.testing.assert_allclose(o["layer_y"], want["y"][rows], rtol=1e-5,
                                   atol=1e-5)
        locals_.add(round(o["layer_aux_local"], 6))
    assert len(locals_) > 1                  # the row shards' own differ
    assert all(abs(a - want["aux"]) > 1e-4 for a in locals_)


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_aux_and_its_gradient_equal_one_process(run, case):
    one = run["one"][case]
    want = one["aux_grad"]
    path = "/" + "/".join(ROUTER)
    idx = [p for p, _ in one["state"]].index(path)
    for o in run["eight"]:
        got = o[case]["aux_grad"]
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-6,
                                   atol=1e-6)
        sl = _blocks(one["mdl"], _mesh(o["coords"]))[idx]
        assert got["grad"].shape == want["grad"][sl].shape
        np.testing.assert_allclose(got["grad"], want["grad"][sl],
                                   rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# checkpoints and the elastic restore
# ---------------------------------------------------------------------------

def test_sharded_checkpoint_is_the_one_process_format(run, tmp_path):
    """The gathered blocks saved by one process give the same files, byte
    for byte, as the eight ranks' save (`save_checkpoint` and
    `AsyncCheckpointer` with the specs; the whisper twin's tree too)."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.optim import tree_unflatten
    saves = {"dense": (run["ckpt"], run["ckpt"] + "_async"),
             "audio": (run["ckpt"] + "_audio",)}
    for case, dirs in saves.items():
        one = run["one"][case]
        mdl = one["mdl"]
        slices = [_blocks(mdl, _mesh(o["coords"])) for o in run["eight"]]
        whole = []
        for i, (path, w) in enumerate(one["state"]):
            arr = np.zeros(w.shape, w.dtype)
            for r, o in enumerate(run["eight"]):
                arr[slices[r][i]] = o[case]["state"][i][1]
            whole.append(torch.from_numpy(arr))
        like = {"params": mdl.param_tree, "opt": {"m": mdl.param_tree,
                                                  "v": mdl.param_tree,
                                                  "count": 0}, "step": 0}
        state = tree_unflatten(like, whole)
        mine = save_checkpoint(str(tmp_path / case), state, 1)
        _same_files(mine, dirs)


def _same_files(mine, dirs):
    for saved in dirs:
        theirs = os.path.join(saved, "step_00000001")
        names = sorted(os.listdir(theirs))
        assert names == sorted(os.listdir(mine)) and len(names) > 10
        for name in names:
            assert filecmp.cmp(os.path.join(mine, name),
                               os.path.join(theirs, name),
                               shallow=False), (saved, name)


def test_sharded_checkpoint_opens_in_the_reference(run):
    from repro import checkpoint as jax_ckpt
    from repro.configs import smoke_config as jax_smoke
    from repro.models import build as jax_build
    from repro.models import steps as JS
    jcfg = dataclasses.replace(jax_smoke(CASES["dense"][0]), dtype="float32",
                               param_dtype="float32")
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
        jax.eval_shape(lambda: JS.init_train_state(jax_build(jcfg), 0)))
    restored, step = jax_ckpt.restore_checkpoint(run["ckpt"], abstract)
    assert step == 1
    got = jax.tree_util.tree_leaves(restored)
    want = run["one"]["dense"]["state"]
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-4, atol=1e-4,
                                   err_msg=path)


def test_elastic_restore_at_2x2_steps_as_the_eight_ranks(run):
    """The (4, 2) checkpoint restored on four ranks at (2, 2): each holds
    its (2, 2) blocks, and the next step's loss is the eight ranks' (and
    the one process's)."""
    mdl = run["one"]["dense"]["mdl"]
    for r, out in enumerate(run["four"]):
        assert out["shape"] == {"data": 2, "model": 2} and out["at"] == 1
        coords = {"data": r // 2, "model": r % 2}
        slices = _blocks(mdl, _mesh(coords, (2, 2)))
        whole = [w.shape for _, w in run["one"]["dense"]["state"]]
        assert out["shapes"] == [tuple(np.empty(s)[sl].shape)
                                 for s, sl in zip(whole, slices)]
        np.testing.assert_allclose(out["loss"], run["eight"][0]["next_loss"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["loss"], run["one"]["next_loss"],
                                   rtol=1e-5, atol=1e-5)


def test_state_from_reference_keeps_the_ranks_blocks(run):
    """`train_state_from_reference(mesh=...)` gives each rank the blocks
    `init_train_state(mesh=...)` draws, the params requiring grad."""
    for o in run["eight"]:
        assert sorted(o["convert"]) == ["audio", "hybrid"]
        for conv in o["convert"].values():
            assert conv and all(equal for _, equal, _ in conv)
            assert sum(grad for _, _, grad in conv) == len(conv) // 3
            assert any(len(shape) and min(shape) for shape, _, _ in conv)
