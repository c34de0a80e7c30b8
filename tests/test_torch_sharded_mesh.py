"""The port's device engines on a (4, 2) ("data", "model") mesh of eight
gloo ranks on the CPU, against the reference's `shard_map` engines on a
(4, 2) mesh of fake CPU devices and against the port's one-shard run
(`mesh=None`), over the streams of tests/test_distributed.py:

  * single view (`ShardedHazy`): forest_like(0.01) cut to 5,816 x 52
    (rows over "data", columns over "model"), M = 1, cap_frac 1/4, 400
    SGD updates of example_stream(seed=3);
  * k views (`ShardedMultiViewHazy`): cora_like(0.8) cut to 2,048 rows,
    cap_frac 1/2, 300 inserts of multiclass_example_stream(seed=11);
    then the same stream through `make_sharded_facade(mesh=...)`.

Each rank writes its block; the reference's arrays are cut into the
same blocks. Reorganizations are counted by process group
(`launch.mesh.CALLS`): a reorganize talks over "model" only (single
view) or not at all (k views)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ranks import Ranks, Reference                    # noqa: E402

SV = dict(updates=400, seed=3, cap_frac=1 / 4, d=52)
MV = dict(n=2048, inserts=300, seed=11, cap_frac=1 / 2)
PROBE_EVERY = 61
SV_CARRY, MV_CARRY = 200, 150      # where the reference's state carries over
ROWS, MODEL = 4, 2
TIMEOUT = 240

SV_STREAM = """
from repro_torch.core import sgd_step, zero_model
from repro_torch.data import example_stream, forest_like, cora_like
from repro_torch.data import multiclass_example_stream
corpus = forest_like(scale=0.01)
n = (corpus.features.shape[0] // 8) * 8
F = np.ascontiguousarray(corpus.features[:n, :{d}])
models, model = [], zero_model({d})
stream = example_stream(corpus, seed={seed}, label_noise=0.0)
for _, f, y in [next(stream) for _ in range({updates})]:
    model = sgd_step(model, f[:{d}], y, lr=0.02, l2=1e-3)
    models.append(model)
"""

MV_STREAM = """
c = cora_like(scale=0.8)
nm, km = {n}, c.num_classes
Fm = np.ascontiguousarray(c.features[:nm]); dm = Fm.shape[1]
Ws, bs, inserts = [], [], []
W = np.zeros((km, dm), np.float32); b = np.zeros(km, np.float64)
lr, l2 = 0.1, 1e-4
stream = multiclass_example_stream(c, seed={seed})
for i, cls in (next(stream) for _ in range({inserts})):
    if i >= nm:
        continue
    f = Fm[i]
    y = np.where(np.arange(km) == cls, 1.0, -1.0)
    z = W @ f - b.astype(np.float32)
    g = np.where(y * z.astype(np.float64) < 1.0, -y, 0.0)
    W = W * (1.0 - lr * l2)
    W -= (lr * g).astype(np.float32)[:, None] * f[None, :]
    b = b - lr * (-g)
    Ws.append(W); bs.append(b); inserts.append((i, cls))
"""

PORT = (SV_STREAM.format(**SV) + MV_STREAM.format(**MV) + """
from repro_torch.core.sharded import (ShardedHazy, ShardedMultiViewHazy,
                                      multiview_reorganize, reorganize)
from repro_torch.core.facade import make_sharded_facade
from repro_torch.core.waters import holder_M
from repro_torch.launch import mesh as mesh_lib
mesh = mesh_lib.make_mesh(({rows}, {model}), ("data", "model"))
OUT["coords"] = dict(mesh.coords)

def calls(before):
    return {{k: v - before.get(k, 0) for k, v in mesh_lib.CALLS.items()
             if v - before.get(k, 0)}}

sh = ShardedHazy(n=n, d={d}, M=1.0, p=2.0, cap_frac={sv_cap},
                 device="cpu", mesh=mesh)
st = sh.init_state(F)
for m in models:
    st = sh.apply_model(st, m.w, m.b)
OUT["sv"] = dict(
    perm=st.perm.numpy(), labels=st.labels.numpy(), eps=st.eps.numpy(),
    rows=(sh.rows.start, sh.rows.stop), cols=(sh.cols.start, sh.cols.stop),
    cap=sh.cap, reorgs=sh.skiing.reorgs, overflows=sh.overflows,
    total_incremental=sh.skiing.total_incremental, a=sh.skiing.a,
    lw=sh.lw, hw=sh.hw, members=sh.all_members(st),
    entity=sh.labels_in_entity_order(st))
before = dict(mesh_lib.CALLS)
_, _, wd, bd = sh._model(models[0].w, models[0].b)
reorganize(st, wd, bd, mesh)
OUT["sv"]["reorg_calls"] = calls(before)

mv = ShardedMultiViewHazy(n=nm, d=dm, k=km, M=holder_M(Fm, 2.0), p=2.0,
                          cap_frac={mv_cap}, device="cpu", mesh=mesh)
ms = mv.init_state(Fm)
for W, b in zip(Ws, bs):
    ms = mv.apply_models(ms, W, b)
probes = [mv.hybrid_labels_of(ms, W, b, i)
          for i in range(0, nm, {probe})]
OUT["mv"] = dict(
    gids=ms.gids.numpy(), labels=ms.labels.numpy(),
    rows=(mv.rows.start, mv.rows.stop), cap=mv.cap, block_n=mv.block_n,
    counts=mv.all_members(ms), reorgs=mv.skiing.reorgs,
    overflows=mv.overflows, total_incremental=mv.skiing.total_incremental,
    lw=mv.lw.copy(), hw=mv.hw.copy(),
    probe_labels=np.stack([p[0] for p in probes]),
    probe_resolved=np.stack([p[1] for p in probes]),
    labels_of=np.stack([mv.labels_of(ms, i)
                        for i in range(0, nm, {probe})]))
before = dict(mesh_lib.CALLS)
multiview_reorganize(ms, torch.tensor(W), torch.tensor(b, dtype=torch.float32))
OUT["mv"]["reorg_calls"] = calls(before)

fac = make_sharded_facade(Fm, km, device="cpu", mesh=mesh)
for j in range(0, len(inserts), 16):
    chunk = inserts[j:j + 16]
    fac.insert_examples([i for i, _ in chunk], [c for _, c in chunk])
OUT["facade"] = dict(
    counts=fac.counts(), members=[fac.members(v) for v in range(km)],
    band_info=[fac.band_info(v) for v in range(km)],
    top=fac.top_margins(1, limit=5),
    point=[fac.point_labels_of(i)[0] for i in range(0, nm, {probe})])

# the reference's (4, 2) states at update {sv_carry} and insert {mv_carry},
# each rank keeping its block, continued to the end of both streams
import time
from repro_torch.core.convert import from_reference, single_view_from_reference
carry_path = os.environ["RANKS_CARRY"]
deadline = time.monotonic() + 180
while not os.path.exists(carry_path):
    assert time.monotonic() < deadline, "no reference snapshot"
    time.sleep(0.2)
with open(carry_path, "rb") as f:
    carry = pickle.load(f)
sh2, st2 = single_view_from_reference(*carry["sv"], device="cpu", mesh=mesh)
for m in models[{sv_carry}:]:
    st2 = sh2.apply_model(st2, m.w, m.b)
fac2 = from_reference(*carry["mv"], device="cpu", mesh=mesh)
ms2 = fac2.state
for W, b in zip(Ws[{mv_carry}:], bs[{mv_carry}:]):
    ms2 = fac2.driver.apply_models(ms2, W, b)
OUT["carry"] = dict(
    sv_perm=st2.perm.numpy(), sv_labels=st2.labels.numpy(),
    sv_reorgs=sh2.skiing.reorgs, sv_overflows=sh2.overflows,
    sv_waters=(sh2.lw, sh2.hw), mv_gids=ms2.gids.numpy(),
    mv_labels=ms2.labels.numpy(), mv_counts=fac2.driver.all_members(ms2),
    mv_reorgs=fac2.driver.skiing.reorgs,
    mv_waters=(fac2.driver.lw.copy(), fac2.driver.hw.copy()))
""").format(rows=ROWS, model=MODEL, d=SV["d"], sv_cap=SV["cap_frac"],
            mv_cap=MV["cap_frac"], probe=PROBE_EVERY, sv_carry=SV_CARRY,
            mv_carry=MV_CARRY)

REFERENCE = (SV_STREAM.replace("repro_torch", "repro").format(**SV)
             + MV_STREAM.format(**MV) + """
import jax, jax.numpy as jnp
from repro.core.sharded import ShardedHazy, ShardedMultiViewHazy
from repro.core.waters import holder_M
from repro.launch.mesh import make_mesh
mesh = make_mesh(({rows}, {model}), ("data", "model"))
sh = ShardedHazy(mesh=mesh, n=n, d={d}, M=1.0, p=2.0, cap_frac={sv_cap})
overflows = [0]
hazy = sh._hazy
def counted(state, w, b):
    state, wsum, wmax = hazy(state, w, b)
    overflows[0] += int(wmax) > sh.cap
    return state, wsum, wmax
sh._hazy = counted
st = sh.init_state(F)
carry = {{}}
for i, m in enumerate(models):
    if i == {sv_carry}:
        carry["sv"] = (
            {{f: np.asarray(getattr(st, f)) for f in st._fields}},
            dict(lw=sh.lw, hw=sh.hw, skiing_a=sh.skiing.a,
                 reorgs=sh.skiing.reorgs,
                 total_incremental=sh.skiing.total_incremental, M=sh.M,
                 p=sh.p, alpha=sh.alpha, cap_frac=sh.cap_frac,
                 overflows=overflows[0]))
    st = sh.apply_model(st, jnp.asarray(m.w), jnp.asarray(m.b, jnp.float32))
OUT["sv"] = dict(
    perm=np.asarray(st.perm), labels=np.asarray(st.labels),
    eps=np.asarray(st.eps), cap=sh.cap, reorgs=sh.skiing.reorgs,
    overflows=overflows[0], total_incremental=sh.skiing.total_incremental,
    a=sh.skiing.a, lw=sh.lw, hw=sh.hw, members=sh.all_members(st))
mv = ShardedMultiViewHazy(mesh=mesh, n=nm, d=dm, k=km, M=holder_M(Fm, 2.0),
                          p=2.0, cap_frac={mv_cap})
ms = mv.init_state(Fm)
for i, (W, b) in enumerate(zip(Ws, bs)):
    if i == {mv_carry}:
        carry["mv"] = (
            {{f: np.asarray(getattr(ms, f)) for f in ms._fields}},
            dict(lw=np.array(mv.lw), hw=np.array(mv.hw),
                 skiing_a=mv.skiing.a, reorgs=mv.skiing.reorgs,
                 total_incremental=mv.skiing.total_incremental,
                 overflows=mv.overflows, M=mv.M, p=mv.p, alpha=mv.alpha,
                 cap_frac=mv.cap_frac, lr=0.1, l2=1e-4, W=Ws[i - 1],
                 b=bs[i - 1]))
        import os, pickle
        with open({carry_path!r} + ".tmp", "wb") as f:
            pickle.dump(carry, f)
        os.replace({carry_path!r} + ".tmp", {carry_path!r})
    ms = mv.apply_models(ms, W, b)
probes = [mv.hybrid_labels_of(ms, W, b, i) for i in range(0, nm, {probe})]
OUT["mv"] = dict(
    gids=np.asarray(ms.gids), labels=np.asarray(ms.labels), cap=mv.cap,
    counts=np.asarray(mv.all_members(ms)), reorgs=mv.skiing.reorgs,
    overflows=mv.overflows, total_incremental=mv.skiing.total_incremental,
    lw=np.asarray(mv.lw).copy(), hw=np.asarray(mv.hw).copy(),
    probe_labels=np.stack([np.asarray(p[0]) for p in probes]),
    probe_resolved=np.stack([np.asarray(p[1]) for p in probes]))
""")


def _reference_code(carry_path):
    return REFERENCE.format(
        rows=ROWS, model=MODEL, d=SV["d"], sv_cap=SV["cap_frac"],
        mv_cap=MV["cap_frac"], probe=PROBE_EVERY, sv_carry=SV_CARRY,
        mv_carry=MV_CARRY, carry_path=str(carry_path))


def _one_shard(F, models, Fm, Ws, bs, probe_ids):
    """The port's `mesh=None` runs of both streams, in this process."""
    from repro_torch.core.sharded import ShardedHazy, ShardedMultiViewHazy
    from repro_torch.core.waters import holder_M
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sh = ShardedHazy(n=F.shape[0], d=F.shape[1], M=1.0, p=2.0,
                         cap_frac=SV["cap_frac"], device="cpu")
        st = sh.init_state(F)
        for m in models:
            st = sh.apply_model(st, m.w, m.b)
        nm, dm = Fm.shape
        mv = ShardedMultiViewHazy(n=nm, d=dm, k=Ws[0].shape[0],
                                  M=holder_M(Fm, 2.0), p=2.0,
                                  cap_frac=MV["cap_frac"], device="cpu")
        ms = mv.init_state(Fm)
        for W, b in zip(Ws, bs):
            ms = mv.apply_models(ms, W, b)
        W, b = Ws[-1], bs[-1]
        return dict(
            sv_entity=sh.labels_in_entity_order(st),
            sv_members=sh.all_members(st),
            mv_entity=_entity_order(ms.labels.numpy(), ms.gids.numpy()),
            mv_counts=mv.all_members(ms),
            mv_probes=[mv.hybrid_labels_of(ms, W, b, i)[0]
                       for i in probe_ids])
    finally:
        torch.set_num_threads(threads)


def _entity_order(labels, ids):
    out = np.empty_like(labels)
    out[..., ids] = labels
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_mesh")
    carry = tmp / "carry.pkl"
    ref = Reference(tmp / "reference", _reference_code(carry))
    ranks = Ranks(tmp / "ranks", ROWS * MODEL, code=PORT,
                  env={"RANKS_CARRY": str(carry)})
    try:
        env = {"np": np}
        exec(compile(SV_STREAM.format(**SV) + MV_STREAM.format(**MV),
                     "streams", "exec"), env)
        probe_ids = list(range(0, MV["n"], PROBE_EVERY))
        one = _one_shard(env["F"], env["models"], env["Fm"], env["Ws"],
                         env["bs"], probe_ids)
        outs = ranks.result(TIMEOUT)
        return dict(ref=ref.result(TIMEOUT), ranks=outs, one=one, env=env,
                    probe_ids=probe_ids)
    finally:
        ranks.kill()
        ref.kill()


RANKS = range(ROWS * MODEL)


def _block(out):
    a, b = out["rows"]
    return slice(a, b)


def test_mesh_coordinates_are_row_major(run):
    for r, out in enumerate(run["ranks"]):
        assert out["coords"] == {"data": r // MODEL, "model": r % MODEL}


@pytest.mark.parametrize("rank", RANKS)
def test_single_view_blocks_are_the_references(run, rank):
    """Rows over "data" in blocks of n/4, columns over "model" in blocks
    of d/2 (`NamedSharding(P("data", "model"))`); the cap is the shard's."""
    sv = run["ranks"][rank]["sv"]
    n = run["env"]["F"].shape[0]
    data, model = rank // MODEL, rank % MODEL
    assert sv["rows"] == (data * n // ROWS, (data + 1) * n // ROWS)
    d = SV["d"] // MODEL
    assert sv["cols"] == (model * d, (model + 1) * d)
    assert sv["cap"] == run["ref"]["sv"]["cap"] == max(
        64, int(n // ROWS * SV["cap_frac"]))


@pytest.mark.parametrize("rank", RANKS)
def test_single_view_labels_by_perm(run, rank):
    """The rank's labels are sign(F·w − b) of its perm's entities, and
    equal the reference's block, as do its perm (a position may differ
    only where the reference's eps tie in fp32) and eps (within 1e-6)."""
    sv, ref = run["ranks"][rank]["sv"], run["ref"]["sv"]
    F, m = run["env"]["F"], run["env"]["models"][-1]
    blk = _block(sv)
    truth = np.where(F @ m.w - m.b >= 0, 1, -1)
    assert np.array_equal(truth[sv["perm"]], sv["labels"])
    assert np.array_equal(sv["labels"], ref["labels"][blk])
    ref_eps = ref["eps"][blk]
    by_entity = dict(zip(ref["perm"][blk].tolist(), ref_eps.tolist()))
    moved = np.flatnonzero(sv["perm"] != ref["perm"][blk])
    assert all(abs(by_entity[int(sv["perm"][i])] - ref_eps[i]) <= 1e-6
               for i in moved), moved
    np.testing.assert_allclose(sv["eps"], ref_eps, rtol=0, atol=1e-6)
    assert np.all(np.diff(sv["eps"]) >= 0)           # eps-sorted shard


@pytest.mark.parametrize("rank", RANKS)
def test_single_view_schedules_and_waters(run, rank):
    sv, ref = run["ranks"][rank]["sv"], run["ref"]["sv"]
    assert sv["reorgs"] == ref["reorgs"] > 1
    assert sv["overflows"] == ref["overflows"] >= 1
    assert sv["total_incremental"] == ref["total_incremental"] > 0
    assert sv["a"] == ref["a"]
    for w in ("lw", "hw"):
        assert np.float64(sv[w]).view(np.uint64) == np.float64(
            ref[w]).view(np.uint64)


@pytest.mark.parametrize("rank", RANKS)
def test_single_view_counts_and_entity_labels(run, rank):
    """`all_members` sums over the row shards; every rank's entity-order
    labels are the one-shard run's."""
    sv, one = run["ranks"][rank]["sv"], run["one"]
    assert sv["members"] == run["ref"]["sv"]["members"] == one["sv_members"]
    assert np.array_equal(sv["entity"], one["sv_entity"])


@pytest.mark.parametrize("rank", RANKS)
def test_single_view_reorganize_talks_over_model_only(run, rank):
    """The reorganize's one collective is the sum of partial margins over
    "model": nothing crosses the row shards (the reference's
    test_reorganize_step_has_no_cross_row_collectives)."""
    assert run["ranks"][rank]["sv"]["reorg_calls"] == {(("model",),
                                                         "sum"): 1}


@pytest.mark.parametrize("rank", RANKS)
def test_multiview_blocks_gids_and_labels(run, rank):
    """Whole rows in blocks of n/4, the ranks along "model" alike; gids
    and labels per shard equal the reference's."""
    mv, ref = run["ranks"][rank]["mv"], run["ref"]["mv"]
    data = rank // MODEL
    n_local = MV["n"] // ROWS
    assert mv["rows"] == (data * n_local, (data + 1) * n_local)
    assert (mv["cap"], mv["block_n"]) == (ref["cap"], 512)
    blk = _block(mv)
    assert np.array_equal(mv["gids"], ref["gids"][blk])
    assert np.array_equal(mv["labels"], ref["labels"][:, blk])
    twin = run["ranks"][rank ^ 1]["mv"]        # same data coordinate
    assert np.array_equal(mv["labels"], twin["labels"])


@pytest.mark.parametrize("rank", RANKS)
def test_multiview_counts_schedules_and_waters(run, rank):
    mv, ref = run["ranks"][rank]["mv"], run["ref"]["mv"]
    assert np.array_equal(mv["counts"], ref["counts"])
    assert np.array_equal(mv["counts"], run["one"]["mv_counts"])
    assert mv["reorgs"] == ref["reorgs"] >= 1
    assert mv["overflows"] == ref["overflows"]
    assert mv["total_incremental"] == ref["total_incremental"] > 0
    assert mv["lw"].dtype == np.float64
    assert np.array_equal(mv["lw"].view(np.uint64),
                          ref["lw"].astype(np.float64).view(np.uint64))
    assert np.array_equal(mv["hw"].view(np.uint64),
                          ref["hw"].astype(np.float64).view(np.uint64))


@pytest.mark.parametrize("rank", RANKS)
def test_multiview_hybrid_probe(run, rank):
    """`hybrid_labels_of` every 61st entity: labels and water-resolved
    masks equal the reference's, the labels the one-shard run's and
    the maintained labels (`labels_of`, a masked row sum)."""
    mv, ref = run["ranks"][rank]["mv"], run["ref"]["mv"]
    assert np.array_equal(mv["probe_labels"], ref["probe_labels"])
    assert np.array_equal(mv["probe_resolved"], ref["probe_resolved"])
    assert mv["probe_resolved"].sum() > 0
    assert np.array_equal(mv["probe_labels"],
                          np.stack(run["one"]["mv_probes"]))
    entity = run["one"]["mv_entity"]
    assert np.array_equal(mv["labels_of"], entity[:, run["probe_ids"]].T)


def test_multiview_entity_order_equals_one_shard(run):
    ref = run["ref"]["mv"]
    assert np.array_equal(_entity_order(ref["labels"], ref["gids"]),
                          run["one"]["mv_entity"])


@pytest.mark.parametrize("rank", RANKS)
def test_multiview_reorganize_issues_no_collective(run, rank):
    assert run["ranks"][rank]["mv"]["reorg_calls"] == {}


@pytest.mark.parametrize("rank", RANKS)
def test_facade_on_the_mesh(run, rank):
    """`make_sharded_facade(mesh=...)` after the same inserts in group
    commits of 16: its counts, members, band widths, top margins and
    point reads agree with the maintained labels and across ranks."""
    fac, first = run["ranks"][rank]["facade"], run["ranks"][0]["facade"]
    entity = run["one"]["mv_entity"]
    assert np.array_equal(fac["counts"], (entity == 1).sum(axis=1))
    for v, ids in enumerate(fac["members"]):
        assert np.array_equal(ids, np.flatnonzero(entity[v] == 1))
    assert all(width >= 0 and pos <= count and total == MV["n"]
               for (width, pos, total), count in zip(fac["band_info"],
                                                     fac["counts"]))
    assert np.array_equal(np.stack(fac["point"]),
                          entity[:, run["probe_ids"]].T)
    assert fac["band_info"] == first["band_info"]
    assert all(np.array_equal(a, b) for a, b in zip(fac["top"][:2],
                                                    first["top"][:2]))


@pytest.mark.parametrize("rank", RANKS)
def test_reference_state_carries_to_the_ranks(run, rank):
    """`single_view_from_reference` and `from_reference` with `mesh=`: the
    reference's (4, 2) states gathered to numpy mid-stream, each rank
    keeping its block, continue to the reference's end state."""
    c, ref = run["ranks"][rank]["carry"], run["ref"]
    sv, mv = run["ranks"][rank]["sv"], run["ranks"][rank]["mv"]
    blk_sv, blk_mv = _block(sv), _block(mv)
    assert np.array_equal(c["sv_labels"], ref["sv"]["labels"][blk_sv])
    assert np.array_equal(c["sv_perm"], ref["sv"]["perm"][blk_sv])
    assert (c["sv_reorgs"], c["sv_overflows"]) == (ref["sv"]["reorgs"],
                                                   ref["sv"]["overflows"])
    assert c["sv_waters"] == (ref["sv"]["lw"], ref["sv"]["hw"])
    assert np.array_equal(c["mv_gids"], ref["mv"]["gids"][blk_mv])
    assert np.array_equal(c["mv_labels"], ref["mv"]["labels"][:, blk_mv])
    assert np.array_equal(c["mv_counts"], ref["mv"]["counts"])
    assert c["mv_reorgs"] == ref["mv"]["reorgs"]
    assert all(np.array_equal(a, np.asarray(b, np.float64))
               for a, b in zip(c["mv_waters"], (ref["mv"]["lw"],
                                               ref["mv"]["hw"])))
