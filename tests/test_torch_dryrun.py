"""The dry run of the port (`repro_torch.launch.dryrun`, `analysis`,
`hlo_stats`, `roofline`, `sweep`) against the reference's, on the CPU:

  * (a) every registered config × every shape of SHAPES × both production
    meshes: the rank's `argument_bytes` equals the sum of the per-device
    shard bytes of the reference's abstract inputs, by its
    `resolve_axes` on a stand-in mesh (as tests/test_torch_tp_rules.py);
    `cache_specs(..., long_ctx, padded=True)`'s partition specs equal the
    reference's on that file's four meshes;
  * (b) in a subprocess with 8 fake devices at (2, 4), as
    tests/test_dryrun_small.py runs: the dense, moe, ssm and hybrid
    twins' train and decode cells; the port's `argument_bytes` equals
    XLA's `memory_analysis().argument_size_in_bytes`, but where XLA prunes
    an unused argument (rwkv6's decode: the index, 4 bytes);
  * (c) the dense twin's FLOPs equal an independent analytic count: a
    prefill cell the sum of 2·m·n·k over its products plus the flash
    kernel's cost, a train cell under remat "full" four times the
    forward's products plus two forward and one backward flash call a
    layer; its kernel calls equal the wrapper calls of a CPU run of the
    same step;
  * (d) a dry run of the dense twin's train and decode steps at (4, 2),
    at each rank, records the same (axes, op) -> calls and bytes as that
    rank of a live eight-rank gloo run; that run's train step (its
    residual stream split over "model" by the `seq_sp` rule) equals the
    reference's own step under a (4, 2) jax mesh with the rule in force,
    from the same state;
  * (e) `param_counts` and `model_flops` equal the reference's for all
    ten configs; with the reference's three constants patched in,
    `roofline_row` and `hazy_rows` give the reference's rows on the same
    cell record; `sweep.jobs()` equals the reference's; the acceptance
    cells (tinyllama-1.1b train_4k and hazy-view view_64m, single pod and
    multipod) write the reference's keys and `roofline --md` prints them;
  * (f) `corrected_cell_metrics`' units add up to the whole count within
    1e-6 relative, no product outside them (train) or only the
    unembedding (decode), and their kernel calls times their counts equal
    the whole step's, for the dense and the whisper twins; whisper-tiny's
    cells on both production meshes complete with the reference's keys
    and its two units."""
import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                          # noqa: E402

from torch_ranks import Ranks, Reference                         # noqa: E402

from repro.configs import SHAPES as JSHAPES                      # noqa: E402
from repro.configs import get_config as jax_config               # noqa: E402
from repro.models import build as jax_build                      # noqa: E402
from repro.models import params as JP                            # noqa: E402
from repro.optim.optimizers import opt_specs as jax_opt_specs    # noqa: E402
from repro_torch.configs import SHAPES, ShapeConfig, get_config  # noqa: E402
from repro_torch.configs import smoke_config                     # noqa: E402
from repro_torch.configs.registry import ARCHS                   # noqa: E402
from repro_torch.launch import dryrun                            # noqa: E402
from repro_torch.launch.mesh import Mesh                         # noqa: E402
from repro_torch.models import build                             # noqa: E402
from repro_torch.models import params as TP                      # noqa: E402

TIMEOUT = 300
PROD = {"pod16x16": ((16, 16), ("data", "model")),
        "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHE_MESHES = {"4x2": ((4, 2), ("data", "model")),
                "2x4": ((2, 4), ("data", "model")),
                "16x16": ((16, 16), ("data", "model")),
                "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TWINS = {"dense": "tinyllama-1.1b", "moe": "llama4-scout-17b-a16e",
         "ssm": "rwkv6-3b", "hybrid": "jamba-v0.1-52b"}
SMALL = {"train": ShapeConfig("t", 32, 8, "train"),
         "decode": ShapeConfig("d", 32, 8, "decode")}
BATCH_AXES = {"tokens": ("batch", None), "targets": ("batch", None),
              "img_embeds": ("batch", None, None),
              "frames": ("batch", None, None)}


def _stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _spec_leaves(tree):
    if isinstance(tree, JP.ParamSpec):
        return [tree]
    return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]


def _shard_bytes(shape, dtype, axes, m):
    spec = JP.resolve_axes(tuple(axes), tuple(shape), m, JP.RULE_SETS["tp"])
    sizes = dict(zip(m.axis_names, m.devices.shape))
    n = 1
    for dim, entry in zip(shape, spec):
        parts = [] if entry is None else (
            [entry] if isinstance(entry, str) else list(entry))
        n *= dim // int(np.prod([sizes[a] for a in parts]))
    return n * jnp.dtype(dtype).itemsize


def _reference_argument_bytes(arch, shape_name, m):
    """The per-device bytes of the reference's abstract inputs of a cell
    (`lower_lm_cell`'s), by its rules on the stand-in mesh `m`."""
    cfg = jax_config(arch)
    mdl = jax_build(cfg)
    shape = JSHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    leaves = [(p.shape, p.dtype, p.axes) for p in _spec_leaves(
        mdl.param_tree)]
    if shape.kind == "train":
        leaves += [(p.shape, p.dtype, p.axes)
                   for p in _spec_leaves(jax_opt_specs(mdl.param_tree))]
        leaves.append(((), jnp.int32, ()))
    if shape.kind in ("train", "prefill"):
        s_text = s - (cfg.num_image_tokens if cfg.family == "vlm" else 0)
        batch = {"tokens": ((b, s_text), jnp.int32)}
        if cfg.family == "vlm":
            batch["img_embeds"] = ((b, cfg.num_image_tokens, cfg.d_model),
                                   jnp.bfloat16)
        if cfg.family == "audio":
            batch["frames"] = ((b, cfg.encoder_seq_len, cfg.d_model),
                               jnp.bfloat16)
        if shape.kind == "train":
            batch["targets"] = ((b, s_text), jnp.int32)
        leaves += [(sh, dt, BATCH_AXES[k]) for k, (sh, dt) in batch.items()]
    else:
        cache = mdl.cache_specs(b, s, long_ctx=s >= (1 << 18))
        leaves += [(p.shape, p.dtype, p.axes) for p in _spec_leaves(cache)]
        leaves += [((b, 1), jnp.int32, ("batch", None)), ((), jnp.int32, ())]
    return sum(_shard_bytes(sh, dt, ax, m) for sh, dt, ax in leaves)


def _argument_bytes(arch, shape, mesh, cfg=None):
    lowered, _, _ = dryrun.lower_lm_cell(arch, shape, mesh, cfg=cfg)
    (low, _), = lowered.values()
    return sum(dryrun._storages(low.arguments).values())


# ---------------------------------------------------------------------------
# subprocesses, started once and read by the tests at the end of the file
# ---------------------------------------------------------------------------

REFERENCE = f"""
import dataclasses
import jax
import jax.numpy as jnp
from repro.checkpoint import restore_checkpoint
from repro.configs import smoke_config, ShapeConfig
from repro.data import TokenStream
from repro.models import build
from repro.models.params import RULE_SETS, resolve_axes
from repro.models.steps import (abstract_tree, batch_specs,
                                decode_input_specs, init_train_state,
                                make_decode_step, make_train_step,
                                train_state_specs)
from repro.launch.mesh import make_mesh

# (d): the dense twin's train step at (4, 2), as the reference's launcher
# runs it (`with mesh:` around the jitted step), from the port's drawn
# state, with the residual stream's `seq_sp` rule in force
cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), dtype="float32",
                          param_dtype="float32")
mdl = build(cfg)
mesh = make_mesh((4, 2), ("data", "model"))
state, _ = restore_checkpoint(INIT_CKPT, jax.tree_util.tree_map(
    lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
    jax.eval_shape(lambda: init_train_state(mdl, 0))))
ds = TokenStream(vocab_size=cfg.vocab_size, batch=8, seq_len=32, seed=0)
batch = {{k: jnp.asarray(v) for k, v in ds.batch_at(0).items()}}
step_fn = jax.jit(make_train_step(mdl), donate_argnums=(0,))
with mesh:
    state, m = step_fn(state, batch)
OUT["seq_sp"] = dict(
    spec=tuple(resolve_axes(("batch", "seq_sp", None), (8, 32, cfg.d_model),
                            mesh, RULE_SETS["tp"])),
    loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
    state=[np.asarray(x) for x in jax.tree_util.tree_leaves(state)])

mesh = make_mesh((2, 4), ("data", "model"))
SMALL = {{"train": ShapeConfig("t", 32, 8, "train"),
          "decode": ShapeConfig("d", 32, 8, "decode")}}
for arch in {sorted(TWINS.values())!r}:
    cfg = smoke_config(arch)
    mdl = build(cfg)
    for kind, shape in SMALL.items():
        with mesh:
            if kind == "train":
                low = jax.jit(make_train_step(mdl), donate_argnums=(0,)).lower(
                    train_state_specs(mdl, mesh), batch_specs(cfg, shape, mesh))
            else:
                cache, token, index = decode_input_specs(mdl, shape, mesh)
                low = jax.jit(make_decode_step(mdl), donate_argnums=(1,)).lower(
                    abstract_tree(mdl.param_tree, mesh), cache, token, index)
        ma = low.compile().memory_analysis()
        OUT[(arch, kind)] = int(ma.argument_size_in_bytes)
"""

LIVE = """
import dataclasses
from repro_torch.configs import smoke_config
from repro_torch.data import TokenStream
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build
from repro_torch.models.steps import (init_cache, init_train_state,
                                      make_decode_step, make_train_step)
from repro_torch.models.params import init_params
from repro_torch.launch.mesh import row_block
cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), dtype="float32",
                          param_dtype="float32")
mdl = build(cfg)
mesh = mesh_lib.make_mesh((4, 2), ("data", "model"))
OUT["rank"] = mesh.rank

def records():
    return {k: (v, mesh_lib.BYTES[k]) for k, v in mesh_lib.CALLS.items()}

state = init_train_state(mdl, device="cpu", mesh=mesh)
ds = TokenStream(vocab_size=cfg.vocab_size, batch=8, seq_len=32, seed=0)
batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(0).items()}
mesh_lib.CALLS.clear(); mesh_lib.BYTES.clear()
state, met = make_train_step(mdl, mesh=mesh)(state, batch)
OUT["train"] = records()

def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree.detach().numpy().copy()]
OUT["step"] = dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                   state=leaves(state))
params = init_params(mdl.param_tree, 0, "cpu", mesh)
cache = init_cache(mdl, 8, 32, "cpu", mesh=mesh)
token = torch.zeros((8, 1), dtype=torch.int32)[row_block(mesh, 8)]
step = make_decode_step(mdl, mesh, batch=8, cache_len=32)
mesh_lib.CALLS.clear(); mesh_lib.BYTES.clear()
with torch.no_grad():
    step(params, cache, token, 31)
OUT["decode"] = records()
"""


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The reference's compile (b) and the live ranks (d), started at the
    first test of the file and read at its end."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.models.steps import init_train_state
    d = tmp_path_factory.mktemp("dryrun")
    init = str(d / "init")
    save_checkpoint(init, init_train_state(build(_twin()), device="cpu"), 0)
    ref = Reference(d / "ref", f"INIT_CKPT = {init!r}\n" + REFERENCE)
    ranks = Ranks(d / "ranks", 8, code=LIVE)
    yield {"reference": ref, "ranks": ranks}
    ref.kill()
    ranks.kill()


@pytest.fixture(scope="module")
def reference(started):
    return started["reference"].result(TIMEOUT)


@pytest.fixture(scope="module")
def live(started):
    return started["ranks"].result(TIMEOUT)


def _twin(arch="tinyllama-1.1b", **kw):
    return dataclasses.replace(smoke_config(arch), dtype="float32",
                               param_dtype="float32", **kw)


# ---------------------------------------------------------------------------
# (a) argument bytes and cache specs at full size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(PROD))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_argument_bytes_equal_the_reference_shards(started, arch, shape,
                                                   mesh):
    got = _argument_bytes(arch, shape, Mesh.abstract(*PROD[mesh]))
    assert got == _reference_argument_bytes(arch, shape,
                                            _stand_in(*PROD[mesh]))


@pytest.mark.parametrize("mesh", sorted(CACHE_MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_the_reference(arch, mesh):
    m = _stand_in(*CACHE_MESHES[mesh])
    for b, S, long_ctx in ((128, 32768, False), (1, 524288, True)):
        mine = build(get_config(arch)).cache_specs(b, S, long_ctx,
                                                   padded=True)
        theirs = jax_build(jax_config(arch)).cache_specs(b, S,
                                                         long_ctx=long_ctx)
        got = TP.partition_specs(mine, m)
        want = JP.partition_specs(theirs, m)

        def flat(t):
            if isinstance(t, dict):
                return [x for k in sorted(t) for x in flat(t[k])]
            return [tuple(t)]
        assert flat(got) == flat(want), (arch, mesh, long_ctx)
        assert [(p.shape, p.axes) for p in _spec_leaves(theirs)] == [
            (p.shape, p.axes) for p in flat_specs(mine)]


def flat_specs(tree):
    if isinstance(tree, TP.ParamSpec):
        return [tree]
    return [x for k in sorted(tree) for x in flat_specs(tree[k])]


# ---------------------------------------------------------------------------
# (c) FLOPs against an analytic count; kernel calls against a CPU run
# ---------------------------------------------------------------------------

def _layer_products(cfg, tokens):
    """2·m·n·k of one dense layer's products over `tokens` rows."""
    d, nq, nkv, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, cfg.d_ff)
    return 2 * tokens * d * hd * (2 * nq + 2 * nkv) + 3 * 2 * tokens * d * ff


def _flash(cfg, b, s):
    return 4 * b * cfg.num_heads * s * (s + 1) // 2 * cfg.head_dim


def test_prefill_flops_equal_the_analytic_count():
    cfg = _twin()
    b, s = 4, 64
    lowered, _, _ = dryrun.lower_lm_cell(
        "tinyllama-1.1b", ShapeConfig("p", s, b, "prefill"), None, cfg=cfg)
    m = dryrun.measure(lowered["prefill_step"][0])
    want = cfg.num_layers * (_layer_products(cfg, b * s) + _flash(cfg, b, s)) \
        + 2 * b * cfg.d_model * cfg.padded_vocab()
    assert m["flops"] == want
    assert m["kernels"]["flash_attention"]["calls"] == cfg.num_layers


def test_train_flops_under_full_remat_and_the_kernel_calls_of_a_cpu_run(
        monkeypatch):
    """Under remat "full" every product runs forward, again in the
    backward's recompute, and twice in the backward: four times the
    forward's, the loss's chunks too; but for each layer's last product
    (`w_out`), which the recompute skips: no backward reads its output,
    and torch's checkpoint stops recomputing once the saved tensors are
    back. Each layer calls the flash forward twice and its backward once.
    A CPU run of the same step calls the wrappers' plain versions as
    often."""
    from repro_torch.data import TokenStream
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.steps import init_train_state, make_train_step
    cfg = _twin(remat_policy="full")
    b, s = 4, 64
    lowered, _, _ = dryrun.lower_lm_cell(
        "tinyllama-1.1b", ShapeConfig("t", s, b, "train"), None, cfg=cfg)
    m = dryrun.measure(lowered["train_step"][0])
    k = 2 * (b * s) * cfg.d_model * cfg.padded_vocab()
    fwd = _flash(cfg, b, s)
    w_out = 2 * (b * s) * cfg.d_ff * cfg.d_model
    want = cfg.num_layers * (4 * _layer_products(cfg, b * s) - w_out
                             + 2 * fwd + 10 * fwd // 4) + 4 * k
    assert m["flops"] == want
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("flash_attention_fwd_ref", "fwd"),
                      ("flash_attention_ref", "fwd"),
                      ("flash_attention_bwd_ref", "bwd")):
        fn = getattr(flash_ops, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(flash_ops, name, counted)
    mdl = build(cfg)
    state = init_train_state(mdl, device="cpu")
    ds = TokenStream(vocab_size=cfg.vocab_size, batch=b, seq_len=s, seed=0)
    batch = {key: torch.from_numpy(v) for key, v in ds.batch_at(0).items()}
    make_train_step(mdl)(state, batch)
    assert calls == {"fwd": m["kernels"]["flash_attention"]["calls"],
                     "bwd": m["kernels"]["flash_attention_bwd"]["calls"]}
    assert calls == {"fwd": 2 * cfg.num_layers, "bwd": cfg.num_layers}


# ---------------------------------------------------------------------------
# (e) the roofline, the sweep and the acceptance cells
# ---------------------------------------------------------------------------

def test_param_counts_and_model_flops_equal_the_reference():
    from repro.launch import roofline as JR
    from repro_torch.launch import roofline as R
    assert R.param_counts() == JR.param_counts()
    counts = R.param_counts()
    for arch in ARCHS:
        for sname, sh in SHAPES.items():
            meta = {"kind": sh.kind, "seq_len": sh.seq_len,
                    "global_batch": sh.global_batch}
            assert R.model_flops(arch, meta, counts) == JR.model_flops(
                arch, meta, counts)


def _cells():
    lm = {"arch": "tinyllama-1.1b", "shape": "train_4k", "mesh": "pod16x16",
          "meta": {"family": "dense", "seq_len": 4096, "global_batch": 256,
                   "kind": "train"},
          "steps": [{"step": "train_step", "flops_per_device": 3.9e13,
                     "bytes_per_device": 1.3e12,
                     "collectives": {"total": 3.5e10},
                     "memory": {"temp_bytes": 9.2e9},
                     "loop_corrected": {"corrected": {
                         "flops": 3.86e13, "bytes": 1.35e12,
                         "coll": 3.51e10}}}]}
    hazy = {"arch": "hazy-view", "shape": "view_64m", "mesh": "pod16x16",
            "meta": {"entities": 1 << 26, "feature_dim": 4096},
            "steps": [{"step": name, "flops_per_device": f,
                       "bytes_per_device": by, "collectives": {"total": c},
                       "memory": {"temp_bytes": 1 << 30}}
                      for name, f, by, c in (
                          ("hazy_naive_step", 3.4e10, 2.1e10, 1.6e7),
                          ("hazy_banded_step", 5.3e8, 3.3e8, 2.6e5),
                          ("hazy_reorg_step", 3.4e10, 6.3e10, 1.6e7))]}
    return lm, hazy


def test_rows_equal_the_reference_with_its_constants(monkeypatch):
    from repro.launch import roofline as JR
    from repro_torch.launch import roofline as R
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(R, name, getattr(JR, name))
    lm, hazy = _cells()
    counts = R.param_counts()
    assert R.roofline_row(lm, counts) == JR.roofline_row(lm, counts)
    assert R.hazy_rows(hazy) == JR.hazy_rows(hazy)


def test_the_h100_constants():
    from repro_torch.launch import roofline as R
    assert (R.PEAK_FLOPS, R.HBM_BW, R.ICI_BW) == (989e12, 3.35e12, 50e9)


def test_sweep_jobs_equal_the_reference():
    from repro.launch import sweep as JS
    from repro_torch.launch import sweep as S
    assert S.jobs() == JS.jobs()


def test_acceptance_cells_write_the_reference_keys(tmp_path, capsys):
    from repro_torch.launch import roofline
    keys = {"step", "lower_s", "compile_s", "flops_per_device",
            "bytes_per_device", "collectives", "memory", "hlo_chars"}
    for arch, shape, multipod in (("hazy-view", "view_64m", False),
                                  ("hazy-view", "view_64m", True),
                                  ("tinyllama-1.1b", "train_4k", False),
                                  ("tinyllama-1.1b", "train_4k", True)):
        rec = dryrun.run_cell(arch, shape, multipod, str(tmp_path))
        assert rec["ok"] and rec["num_devices"] == (512 if multipod else 256)
        for step in rec["steps"]:
            assert keys <= set(step)
            assert set(step["memory"]) == {"argument_bytes", "output_bytes",
                                           "temp_bytes", "alias_bytes"}
            assert step["flops_per_device"] > 0
    train = json.loads((tmp_path / "tinyllama-1.1b__train_4k__pod16x16.json"
                        ).read_text())["steps"][0]
    assert train["kernels"]["flash_attention"]["calls"] == 44
    assert train["kernels"]["flash_attention_bwd"]["calls"] == 22
    assert train["memory"]["alias_bytes"] > 0
    capsys.readouterr()
    roofline.main(["--dir", str(tmp_path), "--md"])
    out = capsys.readouterr().out
    assert "| tinyllama-1.1b | train_4k | train_step |" in out
    for step in ("hazy_naive_step", "hazy_banded_step", "hazy_reorg_step"):
        assert f"| hazy-view | view_64m | {step} |" in out


# ---------------------------------------------------------------------------
# (f) the split by unit composes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [
    ("tinyllama-1.1b", "train"), ("tinyllama-1.1b", "decode"),
    ("whisper-tiny", "train"), ("whisper-tiny", "decode")],
    ids=["train", "decode", "audio-train", "audio-decode"])
def test_units_add_up_to_the_whole(arch, kind):
    """The dense twin's units (the layer plan's position, the loss) and
    the whisper twin's (its encoder and decoder layers, the loss)."""
    from repro_torch.launch.analysis import corrected_cell_metrics
    cfg = _twin(arch, remat_policy="full",
                microbatches=2 if kind == "train" else 1)
    mesh = Mesh.abstract((4, 2), ("data", "model"))
    shape = ShapeConfig("c", 32, 8, kind)
    lowered, _, _ = dryrun.lower_lm_cell(arch, shape, mesh, cfg=cfg)
    (low, _), = lowered.values()
    whole = dryrun.measure(low)
    full = {"flops": whole["flops"], "bytes": whole["bytes"],
            "coll": whole["collectives"]["total"]}
    corr = corrected_cell_metrics(build(cfg), shape, mesh, full, kind)
    mb = corr["microbatches"]
    for k in ("flops", "bytes", "coll"):
        total = corr["fixed"][k] + mb * corr["core"][k]
        assert abs(total - corr["corrected"][k]) <= 1e-6 * abs(
            corr["corrected"][k])
        assert corr["corrected"][k] == full[k]
    rows = 8 // mb // 4
    if kind == "train":
        assert corr["fixed"]["flops"] == 0
    else:                                # the unembedding's vocab block
        assert corr["fixed"]["flops"] == (2 * rows * cfg.d_model
                                          * cfg.padded_vocab() // 2)
    calls = {}
    for unit in corr["detail"].values():
        for name, c in unit["kernels"].items():
            calls[name] = calls.get(name, 0) + mb * unit["n"] * c
    assert calls == {name: v["calls"] for name, v in whole["kernels"].items()}
    if arch == "whisper-tiny":
        want = ({"decode_dec_blocks"} if kind == "decode" else
                {"block_enc_blocks", "block_dec_blocks", "loss"})
        assert set(corr["detail"]) == want


@pytest.mark.parametrize("multipod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
def test_whisper_cells_complete_with_the_reference_keys(tmp_path, capsys,
                                                         multipod):
    """whisper-tiny's three cells on a production mesh ("model" 16, which
    does not divide its 6 heads: attention whole on every rank, its cache
    over its 16 padded heads, one a rank): each writes the reference's
    keys; on the single pod the split by unit is the encoder and decoder
    layers (and the loss), and nothing computes outside them in training
    (`fixed` has no FLOPs)."""
    keys = {"step", "lower_s", "compile_s", "flops_per_device",
            "bytes_per_device", "collectives", "memory", "hlo_chars"}
    units = {"train_4k": {"block_enc_blocks", "block_dec_blocks", "loss"},
             "prefill_32k": {"block_enc_blocks", "block_dec_blocks"},
             "decode_32k": {"decode_dec_blocks"}}
    for shape, want in units.items():
        rec = dryrun.run_cell("whisper-tiny", shape, multipod,
                              str(tmp_path))
        assert rec["ok"] and rec["num_devices"] == (512 if multipod
                                                    else 256)
        step, = rec["steps"]
        assert keys <= set(step) and step["flops_per_device"] > 0
        kernel = "decode_attention" if shape == "decode_32k" else \
            "flash_attention"
        assert step["kernels"][kernel]["calls"] > 0
        if multipod:
            assert "loop_corrected" not in step
            continue
        corr = step["loop_corrected"]
        assert set(corr["detail"]) == want
        assert all(u["n"] == 4 for u in corr["detail"].values()
                   if u is not corr["detail"].get("loss"))
        if shape == "train_4k":
            assert corr["fixed"]["flops"] == 0
    capsys.readouterr()


# ---------------------------------------------------------------------------
# (b) and (d): against XLA's argument bytes and a live mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("family", sorted(TWINS))
def test_argument_bytes_equal_xla_on_a_small_mesh(reference, family, kind):
    arch = TWINS[family]
    got = _argument_bytes(arch, SMALL[kind],
                          Mesh.abstract((2, 4), ("data", "model")),
                          cfg=smoke_config(arch))
    want = reference[(arch, kind)]
    if (family, kind) == ("ssm", "decode"):
        # XLA prunes the index, which the ssm family's decode never reads
        assert got == want + 4
    else:
        assert got == want


def test_live_mesh_step_equals_the_reference_with_seq_sp(reference, live):
    """The live eight ranks' train step at (4, 2), the residual stream
    split over "model", against the reference's step at (4, 2) with its
    `seq_sp` rule in force (the stream `P("data", "model", None)`): loss,
    grad_norm and each rank's block of every state leaf within 1e-4."""
    from repro_torch.models.steps import train_state_specs
    from repro_torch.optim import tree_leaves
    want = reference["seq_sp"]
    assert want["spec"] == ("data", "model", None)
    for out in live:
        got = out["step"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        mesh = Mesh.abstract((4, 2), ("data", "model"), out["rank"])
        specs = tree_leaves(train_state_specs(build(_twin()), mesh))
        assert len(got["state"]) == len(want["state"]) == len(specs)
        for g, w, sh in zip(got["state"], want["state"], specs):
            assert g.shape == w[sh.slices].shape
            np.testing.assert_allclose(g, w[sh.slices], rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dry_mesh_records_equal_a_live_mesh(live, kind):
    cfg = _twin()
    shape = ShapeConfig("x", 32, 8, kind)
    for out in live:
        mesh = Mesh.abstract((4, 2), ("data", "model"), out["rank"])
        lowered, _, _ = dryrun.lower_lm_cell("tinyllama-1.1b", shape, mesh,
                                             cfg=cfg)
        (low, _), = lowered.values()
        dryrun.measure(low)
        from repro_torch.launch import mesh as mesh_lib
        got = {k: (v, mesh_lib.BYTES[k]) for k, v in mesh_lib.CALLS.items()}
        assert got == out[kind], out["rank"]
