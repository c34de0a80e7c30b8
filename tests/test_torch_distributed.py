"""The port's `torch.distributed` slice on the CPU (gloo ranks), against
the reference's multi-device programs of tests/test_distributed.py:

  * the int8 error-feedback all-reduce (`distributed/compression.py`) on
    8 ranks against the reference's on 8 fake devices, over 3 rounds of
    error feedback on the inputs of test_compressed_allreduce_accuracy:
    q, the scale, err' and the mean bit for bit;
  * the mesh helpers (`launch/mesh.py`): shapes, axis names, row-major
    coordinates, the groups, and the production meshes raising at world
    8 with the size they need;
  * the data-parallel training step (`make_train_step(mesh=...)`): 3
    steps of the tinyllama smoke twin in f32 on a (4, 2) mesh against one
    process on the global batch (loss and grad_norm within 1e-5; params,
    m and v within 1e-4; params bit for bit alike on every rank);
  * the elastic restore (test_elastic_remesh_restore's analog): rank 0
    saves at step 3, a world of 4 restores on `make_elastic_mesh(4,
    model_parallel=2)` and takes step 4 as the 8 ranks did; the
    checkpoint opens in the reference's `restore_checkpoint`;
  * the launcher: `--mesh pod` at world 8 raises on every rank; `--mesh
    host` trains as before."""
import dataclasses
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import torch.distributed as dist                            # noqa: E402

from torch_ranks import Ranks, Reference                    # noqa: E402

TIMEOUT = 180
ROUNDS = 3
ARCH, BATCH, SEQ, STEPS = "tinyllama-1.1b", 8, 16, 3

TWIN = f"""
import dataclasses
from repro_torch.configs import smoke_config
from repro_torch.data import TokenStream
from repro_torch.models import build
cfg = dataclasses.replace(smoke_config({ARCH!r}), dtype="float32",
                          param_dtype="float32")
mdl = build(cfg)
ds = TokenStream(vocab_size=cfg.vocab_size, batch={BATCH}, seq_len={SEQ},
                 seed=0)

def batch(i):
    return {{k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}}
"""

LEAVES = """
def leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{path}/{k}")]
    return [(path, tree.detach().numpy().copy())]

def digest(state):
    h = hashlib.sha256()
    for _, a in leaves(state):
        h.update(a.tobytes())
    return h.hexdigest()
"""

EIGHT = TWIN + LEAVES + f"""
import hashlib
from repro_torch.checkpoint import save_checkpoint
from repro_torch.distributed import (compress_int8,
                                     make_compressed_grad_allreduce)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.steps import init_train_state, make_train_step

# the mesh helpers
m42 = mesh_lib.make_mesh((4, 2), ("data", "model"))
OUT["mesh"] = dict(shape=m42.shape, axes=m42.axis_names, coords=m42.coords,
                   devices=m42.devices.tolist(), row_axes=m42.row_axes,
                   data_ranks=dist.get_process_group_ranks(m42.group("data")),
                   model_ranks=dist.get_process_group_ranks(
                       m42.group("model")))
OUT["host_mesh"] = mesh_lib.make_host_mesh((4, 2)).shape
OUT["elastic"] = mesh_lib.make_elastic_mesh(8, model_parallel=2).shape
errors = {{}}
for name, fn in [("pod", lambda: mesh_lib.make_production_mesh()),
                 ("multipod", lambda: mesh_lib.make_production_mesh(
                     multi_pod=True)),
                 ("host", lambda: mesh_lib.make_host_mesh()),
                 ("elastic", lambda: mesh_lib.make_elastic_mesh(8))]:
    try:
        fn()
    except ValueError as e:
        errors[name] = str(e)
OUT["errors"] = errors
m3 = mesh_lib.make_mesh((2, 2, 2), ("pod", "data", "model"))
OUT["pod_mesh"] = dict(coords=m3.coords, rows=m3.index(m3.row_axes),
                       row_ranks=dist.get_process_group_ranks(
                           m3.group(m3.row_axes)))

# the int8 error-feedback all-reduce over ("pod",) of 8
m8 = mesh_lib.make_mesh((8,), ("pod",))
allred = make_compressed_grad_allreduce(m8, "pod", 8)
g_all = torch.tensor(np.random.default_rng(0).normal(size=(8, 64)),
                     dtype=torch.float32)
err, rounds = torch.zeros(64), []
for step in range({ROUNDS}):
    g = g_all[RANK] * (1.0 + 0.1 * step)
    q, scale, new_err = compress_int8(g, err, m8, "pod")
    mean, err2 = allred({{"g": g}}, {{"g": err}})
    err = err2["g"]
    rounds.append(dict(g=g.numpy(), q=q.numpy(), scale=scale.numpy(),
                       new_err=new_err.numpy(), mean=mean["g"].numpy(),
                       err=err.numpy()))
OUT["rounds"] = rounds

# the data-parallel step on (4, 2), a checkpoint at step {STEPS}, one more
state = init_train_state(mdl, device="cpu")
step_fn = make_train_step(mdl, mesh=m42)
metrics = []
for i in range({STEPS}):
    state, m = step_fn(state, batch(i))
    metrics.append({{k: float(v) for k, v in m.items()}})
save_checkpoint(os.environ["RANKS_CKPT"], state, {STEPS})
OUT["metrics"] = metrics
OUT["digest"] = digest(state)
if RANK == 0:
    OUT["state"] = leaves(state)
state, m = step_fn(state, batch({STEPS}))
OUT["next_loss"] = float(m["loss"])
"""

FOUR = TWIN + f"""
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.models.steps import make_train_step, train_state_specs
mesh4 = make_elastic_mesh(4, model_parallel=2)
state, at = restore_checkpoint(os.environ["RANKS_CKPT"],
                               train_state_specs(mdl, mesh4), device="cpu")
state, m = make_train_step(mdl, mesh=mesh4)(state, batch(at))
OUT.update(shape=mesh4.shape, at=at, loss=float(m["loss"]))
"""

REFERENCE = f"""
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.sharded import shard_map
from repro.distributed import compress_int8, make_compressed_grad_allreduce
from repro.launch.mesh import make_mesh
mesh = make_mesh((8,), ("pod",))
allred = make_compressed_grad_allreduce("pod", 8)

def f(g, err):
    q, scale, new_err = compress_int8(g, err, "pod")
    out, err2 = allred({{"g": g}}, {{"g": err}})
    return q, scale.reshape(1), new_err, out["g"], err2["g"]

fn = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("pod"), P("pod")),
                       out_specs=(P("pod"),) * 5))
g_all = jnp.asarray(np.random.default_rng(0).normal(size=(8, 64)),
                    jnp.float32)
err, rounds = jnp.zeros((8, 64), jnp.float32), []
for step in range({ROUNDS}):
    g = g_all * (1.0 + 0.1 * step)
    q, scale, new_err, mean, err = fn(g, err)
    rounds.append({{k: np.asarray(v) for k, v in dict(
        g=g, q=q, scale=scale, new_err=new_err, mean=mean, err=err).items()}})
OUT["rounds"] = rounds
"""


def _twin():
    from repro_torch.configs import smoke_config
    from repro_torch.data import TokenStream
    from repro_torch.models import build
    cfg = dataclasses.replace(smoke_config(ARCH), dtype="float32",
                              param_dtype="float32")
    return cfg, build(cfg), TokenStream(vocab_size=cfg.vocab_size,
                                        batch=BATCH, seq_len=SEQ, seed=0)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                          f"{path}/{k}")]
    return [(path, tree.detach().numpy().copy())]


def _one_process():
    """3 steps of the twin in this process on the global batch."""
    from repro_torch.models.steps import init_train_state, make_train_step
    _, mdl, ds = _twin()
    state = init_train_state(mdl, device="cpu")
    step_fn = make_train_step(mdl)
    metrics = []
    for i in range(STEPS + 1):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}
        state, m = step_fn(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if i + 1 == STEPS:
            at_steps = _leaves(state)
    return dict(metrics=metrics, state=at_steps)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distributed")
    ckpt = str(tmp / "ckpt")
    ref = Reference(tmp / "reference", REFERENCE)
    eight = Ranks(tmp / "eight", 8, code=EIGHT, env={"RANKS_CKPT": ckpt})
    four = None
    try:
        one = _one_process()
        outs = eight.result(TIMEOUT)
        four = Ranks(tmp / "four", 4, code=FOUR, env={"RANKS_CKPT": ckpt})
        fours = four.result(TIMEOUT)
        return dict(ref=ref.result(TIMEOUT), eight=outs, four=fours, one=one,
                    ckpt=ckpt, tmp=tmp)
    finally:
        for job in (ref, eight, four):
            if job is not None:
                job.kill()


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rnd", range(ROUNDS))
@pytest.mark.parametrize("key", ["q", "scale", "new_err", "mean", "err"])
def test_compression_bit_for_bit(run, rnd, key):
    """Every rank's q, scale, err' and mean (and the error carried to the
    next round) equal the reference shard's bit for bit."""
    ref = run["ref"]["rounds"][rnd]
    for r, out in enumerate(run["eight"]):
        got = out["rounds"][rnd]
        assert np.array_equal(got["g"], ref["g"][r])          # same input
        want = ref[key][r:r + 1] if key == "scale" else ref[key][r]
        assert got[key].dtype == want.dtype, (key, got[key].dtype)
        assert np.array_equal(np.atleast_1d(got[key]).view(np.uint8),
                              np.atleast_1d(want).view(np.uint8)), (r, key)


def test_compression_mean_tracks_the_true_mean(run):
    """Error feedback keeps the running mean near the true mean (the
    reference test's property, over 3 rounds)."""
    hat = sum(run["eight"][0]["rounds"][i]["mean"] for i in range(ROUNDS))
    true = sum(np.mean([o["rounds"][i]["g"] for o in run["eight"]], axis=0)
               for i in range(ROUNDS))
    assert np.abs(hat - true).max() / np.abs(true).max() < 0.02
    assert all(o["rounds"][0]["q"].dtype == np.int8 for o in run["eight"])


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------

def test_import_touches_no_process_group():
    import repro_torch.launch.mesh as mesh_lib
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_lib.make_host_mesh()


@pytest.mark.parametrize("rank", range(8))
def test_mesh_shapes_names_and_groups(run, rank):
    out = run["eight"][rank]
    m = out["mesh"]
    assert m["shape"] == {"data": 4, "model": 2}
    assert m["axes"] == ("data", "model") and m["row_axes"] == ("data",)
    assert m["coords"] == {"data": rank // 2, "model": rank % 2}
    assert m["devices"] == np.arange(8).reshape(4, 2).tolist()
    assert m["data_ranks"] == [rank % 2 + 2 * i for i in range(4)]
    assert m["model_ranks"] == [rank - rank % 2, rank - rank % 2 + 1]
    assert out["host_mesh"] == {"data": 4, "model": 2}
    assert out["elastic"] == {"data": 4, "model": 2}
    p = out["pod_mesh"]
    assert p["coords"] == {"pod": rank // 4, "data": rank // 2 % 2,
                           "model": rank % 2}
    assert p["rows"] == rank // 2           # pod-major over (pod, data)
    assert p["row_ranks"] == [rank % 2 + 2 * i for i in range(4)]


def test_production_meshes_raise_with_the_size_they_need(run):
    for out in run["eight"]:
        e = out["errors"]
        assert "256" in e["pod"] and "8" in e["pod"]
        assert "512" in e["multipod"]
        assert "needs 1 ranks" in e["host"]
        assert "model groups of 16" in e["elastic"]


# ---------------------------------------------------------------------------
# the data-parallel training step and the elastic restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", range(8))
def test_train_step_on_the_mesh_equals_one_process(run, rank):
    out, one = run["eight"][rank], run["one"]
    for got, want in zip(out["metrics"], one["metrics"][:STEPS]):
        for k in ("loss", "grad_norm", "nll", "lr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    assert out["digest"] == run["eight"][0]["digest"]   # replicated state


def test_train_state_on_the_mesh_equals_one_process(run):
    got, want = run["eight"][0]["state"], run["one"]["state"]
    assert [p for p, _ in got] == [p for p, _ in want]
    kinds = {p.split("/")[1] for p, _ in got}
    assert kinds == {"params", "opt", "step"}
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=path)


def test_elastic_restore_on_four_ranks_trains_on(run):
    """Step 4 after restoring the 8-rank checkpoint on a world of 4
    ((2, 2) elastic mesh): finite and within the f32 tolerance of the
    uninterrupted 8-rank run's step 4 and the one process's."""
    eight = run["eight"][0]["next_loss"]
    for out in run["four"]:
        assert out["shape"] == {"data": 2, "model": 2} and out["at"] == STEPS
        assert np.isfinite(out["loss"])
        np.testing.assert_allclose(out["loss"], eight, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["loss"],
                                   run["one"]["metrics"][STEPS]["loss"],
                                   rtol=1e-5, atol=1e-5)
    assert len({o["loss"] for o in run["four"]}) == 1


def test_eight_rank_checkpoint_opens_in_the_reference(run):
    """Rank 0 alone wrote it, in the reference's format: the reference's
    `restore_checkpoint` reads the state rank 0 held."""
    from repro import checkpoint as jax_ckpt
    from repro.configs import smoke_config as jax_smoke
    from repro.models import build as jax_build
    from repro.models import steps as JS
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32",
                               param_dtype="float32")
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
        jax.eval_shape(lambda: JS.init_train_state(jax_build(jcfg), 0)))
    restored, step = jax_ckpt.restore_checkpoint(run["ckpt"], abstract)
    assert step == STEPS
    got = jax.tree_util.tree_leaves(restored)
    want = run["eight"][0]["state"]
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        assert np.array_equal(np.asarray(g), w), path


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_pod_mesh_at_world_8_raises(run):
    import sys
    d = run["tmp"] / "launcher"
    ranks = Ranks(d, 8, argv=[
        sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
        "--smoke", "--device", "cpu", "--mesh", "pod", "--init-method",
        "file://" + str(d / "rendezvous")])
    try:
        done = ranks.wait(TIMEOUT)
    finally:
        ranks.kill()
    for rc, log in done:
        assert rc != 0
        assert "needs 256 ranks; the process group has 8" in log, log[-2000:]


def test_launcher_host_mesh_is_unchanged(tmp_path):
    """`--mesh host` runs the one-device loop: its log line is the loss
    of `make_train_step` on the same batches."""
    from repro_torch.launch.train import main
    from repro_torch.models.steps import init_train_state, make_train_step
    from repro_torch.configs import smoke_config
    from repro_torch.data import TokenStream
    from repro_torch.models import build
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", "host",
              "--steps", "2", "--batch", "2", "--seq", "16", "--log-every",
              "1"])
    lines = buf.getvalue().splitlines()
    mdl = build(smoke_config(ARCH))
    ds = TokenStream(vocab_size=mdl.cfg.vocab_size, batch=2, seq_len=16,
                     seed=0)
    state = init_train_state(mdl, device="cpu")
    step_fn = make_train_step(mdl, lr=1e-3, warmup=20, total_steps=2)
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}
        state, m = step_fn(state, batch)
    assert lines[-1] == f"[train] done at step 2, final loss " \
                        f"{float(m['loss']):.4f}"
    assert lines[0].startswith("[train] step 1 loss ")
    assert not dist.is_initialized()

