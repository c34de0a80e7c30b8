"""The view engine's spans and counters (`repro_torch.obs.Tracer` armed in
`make_sharded_facade`), on the CPU at a small size: the span tree of each
kind of round and read, with one `<where>.sync` span a blocking
host↔device transfer (the CPU path has the same transfer sites as the
card's); each span counted once in its histogram; `kernels.union_rows`,
held until the snapshot, against a direct union of the windows each
launch was given, with no transfer of its own; an unarmed
facade that runs no tracing code; armed and unarmed facades that agree
bit for bit; the anchor that lays a span on the profiler's clock."""
import numpy as np
import pytest
import torch

from repro_torch.core import sharded
from repro_torch.core.facade import make_sharded_facade
from repro_torch.core.sharded import union_rows_of
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.band_reclassify import ops
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.obs import trace as obs_trace

N, D, K, GROUP = 4096, 16, 4, 8
INCREMENTAL = [("driver.sync", "W"), ("driver.sync", "b"),
               ("driver.sync", "W_stored"), ("driver.sync", "b_stored"),
               ("driver.waters", None), ("driver.sync", "lw"),
               ("driver.sync", "hw"), ("driver.relabel", None),
               ("driver.sync", "overflow"), ("driver.sync", "wsum")]


def _table(seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 0.8, (K, D))
    cls = rng.integers(0, K, N)
    F = centres[cls] + rng.normal(0, 1, (N, D))
    F /= np.linalg.norm(F, axis=1, keepdims=True)
    return F.astype(np.float32), cls


def _stream(cls, seed=1, commits=40):
    rng = np.random.default_rng(seed)
    for _ in range(commits):
        ids = rng.integers(0, N, GROUP)
        yield [int(i) for i in ids], [int(cls[i]) for i in ids]


def _armed(F, keep=True):
    tr = Tracer(MetricsRegistry())
    tr.keep = keep
    return make_sharded_facade(F, K, device="cpu", tracer=tr), tr


def _shape(sp):
    return [(c.name, c.attrs.get("what")) for c in sp.children]


def _commit_trees(fac, tr, cls, commits=40):
    tr.kept.clear()
    for ids, labels in _stream(cls, commits=commits):
        fac.insert_examples(ids, labels)
    trees = list(tr.kept)
    assert [t.name for t in trees] == ["facade.commit"] * commits
    return trees


def test_build_is_one_tree():
    F, _ = _table()
    fac, tr = _armed(F)
    (root,) = tr.kept
    assert root.name == "facade.build" and root.attrs == {"views": K}
    assert [c.name for c in root.children] == [
        "build.host_copy", "build.holder_M", "build.upload",
        "build.reorganize"]
    assert tr.metrics.histogram("span.facade.build.seconds").count == 1
    assert fac.driver.tracer is tr


def test_incremental_commit_tree():
    F, cls = _table()
    fac, tr = _armed(F)
    trees = _commit_trees(fac, tr, cls)
    inc = [t for t in trees if t.children[1].attrs["kind"] == "incremental"]
    assert inc
    for t in inc:
        assert t.attrs == {"rows": GROUP}
        assert [c.name for c in t.children] == ["facade.sgd", "driver.round"]
        rnd = t.children[1]
        assert _shape(rnd) == INCREMENTAL
        assert sum(c.name == "driver.sync" for c in rnd.children) == 8
        assert not rnd.children[4].children        # waters: host only


def test_overflow_and_skiing_rounds_reorganize():
    F, cls = _table()
    fac, tr = _armed(F)
    ids, labels = next(_stream(cls))
    fac.insert_examples(ids, labels)    # zero models: every row in the band
    rnd = tr.kept[-1].children[1]
    assert rnd.attrs["kind"] == "overflow"
    assert _shape(rnd) == INCREMENTAL[:-1] + [("driver.reorganize", None)]
    fac.driver.skiing.should_reorganize = lambda: True
    fac.insert_examples(ids, labels)
    rnd = tr.kept[-1].children[1]
    assert rnd.attrs["kind"] == "reorg"
    assert _shape(rnd) == [("driver.sync", "W"), ("driver.sync", "b"),
                           ("driver.reorganize", None)]


def test_point_read_trees():
    """One shard reads on the host: a water-resolved read is `read.probe`
    over one `read.sync` "eps"; the gather adds `read.gather` over the
    uploads of W and b and the read back of the labels; the first read of
    a new `gids` reads it back first to build the index."""
    F, cls = _table()
    fac, tr = _armed(F)
    for ids, labels in _stream(cls, commits=12):
        fac.insert_examples(ids, labels)
    tr.kept.clear()
    for i in range(0, N, 7):
        fac.point_labels_of(i)
    gathered = 0
    for j, t in enumerate(tr.kept):
        assert t.name == "facade.point_read"
        syncs = sum(s.name == "read.sync" for s in t.walk())
        built = [("read.sync", "gids")] if j == 0 else []
        probe = t.children[0]
        assert probe.name == "read.probe"
        assert _shape(probe) == built + [("read.sync", "eps")]
        if len(t.children) > 1:
            gathered += 1
            assert [c.name for c in t.children] == ["read.probe",
                                                    "read.gather"]
            assert _shape(t.children[1]) == [
                ("read.sync", "W"), ("read.sync", "b"), ("read.sync", "z")]
            assert syncs == 4 + len(built)
        else:
            assert syncs == 1 + len(built)
    assert 0 < gathered < len(tr.kept)
    assert tr.metrics.counter("read.index_builds").value == 1


def test_members_tree():
    F, cls = _table()
    fac, tr = _armed(F)
    for ids, labels in _stream(cls, commits=5):
        fac.insert_examples(ids, labels)
    tr.kept.clear()
    got = fac.members(2)
    (t,) = tr.kept
    assert t.name == "facade.members" and t.attrs == {"view": 2}
    assert _shape(t) == [("members.sync", "mask"), ("members.sync", "ids")]
    lab = fac.state.labels[2].numpy()
    want = np.sort(fac.state.gids.numpy()[lab == 1])
    assert np.array_equal(got, want)


def test_histograms_count_each_span_once():
    F, cls = _table()
    fac, tr = _armed(F)
    tr.kept.clear()
    for j, (ids, labels) in enumerate(_stream(cls)):
        fac.insert_examples(ids, labels)
        fac.point_labels_of(ids[0])
        if j % 5 == 0:
            fac.members(j % K)
    names = {}
    for t in tr.kept:
        for s in t.walk():
            names[s.name] = names.get(s.name, 0) + 1
    hists = tr.snapshot()["histograms"]
    for where in ("driver", "read", "members"):
        assert names[f"{where}.sync"] > 0
    for name, n in names.items():
        assert hists[f"span.{name}.seconds"]["count"] == n
    assert names["facade.commit"] == names["driver.round"] == 40


@pytest.mark.parametrize("limit", [Tracer.DEFER_LIMIT, 3])
def test_union_rows_counts_the_windows_each_launch_was_given(monkeypatch,
                                                             limit):
    F, cls = _table()
    fac, tr = _armed(F, keep=False)
    monkeypatch.setattr(tr, "DEFER_LIMIT", limit)
    reads = []
    monkeypatch.setattr(sharded, "union_rows_of",
                        lambda w: reads.append(len(w)) or union_rows_of(w))
    seen = []
    real = ops.multiview_band_reclassify_ref

    def spy(F, labels, W, b, start_blocks, widths, *, cap, block_n):
        seen.append((start_blocks.clone(), widths.clone(), block_n))
        return real(F, labels, W, b, start_blocks, widths, cap=cap,
                    block_n=block_n)
    monkeypatch.setattr(ops, "multiview_band_reclassify_ref", spy)
    for ids, labels in _stream(cls):
        fac.insert_examples(ids, labels)
    assert len(seen) >= 30
    direct = 0
    for sb, wd, block_n in seen:
        rows = np.zeros(N, bool)
        for s, w in zip(sb.tolist(), wd.tolist()):
            rows[s * block_n:s * block_n + w] = True
        direct += int(rows.sum())
    assert direct > 0
    if limit == 3:                  # counted in threes as the rounds go
        assert reads == [3] * (len(seen) // 3)
    else:                           # held: not one read in the rounds
        assert reads == [] and "kernels.union_rows" in tr.pending
    tr.snapshot()
    assert not tr.pending and sum(reads) == len(seen)
    if limit != 3:                  # one read of them all
        assert reads == [len(seen)]
    assert tr.metrics.counter("kernels.union_rows").value == direct


@pytest.mark.parametrize("seed", range(4))
def test_window_union_rows_equals_a_mask(seed):
    rng = np.random.default_rng(seed)
    k, block_n, n = 9, 8, 512
    sb = rng.integers(0, n // block_n, k)
    wd = rng.integers(0, 96, k) * (rng.random(k) < 0.8)
    rows = np.zeros(n + 96, bool)
    for s, w in zip(sb, wd):
        rows[s * block_n:s * block_n + w] = True
    assert ops.window_union_rows(sb.tolist(), wd.tolist(),
                                 block_n) == rows.sum()


def test_unarmed_runs_no_tracing_code(monkeypatch):
    F, cls = _table()
    fac = make_sharded_facade(F, K, device="cpu")

    def boom(*a, **kw):
        raise AssertionError("tracing code ran unarmed")
    monkeypatch.setattr(obs_trace, "start", boom)
    monkeypatch.setattr(obs_trace, "finish", boom)
    for name in ("counter", "gauge", "histogram"):
        monkeypatch.setattr(MetricsRegistry, name, boom)
    for name in ("span", "start", "finish", "count", "defer", "snapshot"):
        monkeypatch.setattr(Tracer, name, boom)
    assert fac.driver.tracer is None
    for ids, labels in _stream(cls, commits=6):
        fac.insert_examples(ids, labels)
        fac.point_labels_of(ids[1])
        fac.members(1)


def test_armed_and_unarmed_agree_bit_for_bit():
    F, cls = _table()
    plain = make_sharded_facade(F, K, device="cpu")
    armed, _ = _armed(F, keep=False)
    for ids, labels in _stream(cls):
        for fac in (plain, armed):
            fac.insert_examples(ids, labels)
        a, ha = plain.point_labels_of(ids[2])
        b, hb = armed.point_labels_of(ids[2])
        assert np.array_equal(a, b) and ha == hb
    assert np.array_equal(plain.W, armed.W)
    assert np.array_equal(plain.b, armed.b)
    for field in ("labels", "gids", "eps", "W_stored", "b_stored"):
        assert torch.equal(getattr(plain.state, field),
                           getattr(armed.state, field)), field
    for v in range(K):
        assert np.array_equal(plain.members(v), armed.members(v))
    assert plain.driver.skiing == armed.driver.skiing


def test_tracer_keeps_roots_only_when_asked():
    tr = Tracer(MetricsRegistry())
    with tr.span("a"):
        pass
    assert tr.kept == []
    tr.keep = True
    with tr.span("root"):
        with tr.span("child"):
            pass
    assert [t.name for t in tr.kept] == ["root"]
    tr.count("c", 3)
    tr.count("c")
    assert tr.metrics.counter("c").value == 4
    Tracer().count("c")                        # no registry: nothing kept


def test_anchor_maps_a_span_onto_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function
    tr = Tracer(MetricsRegistry())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with tr.span("outer") as sp:
                with record_function("view_trace.inner"):
                    torch.ones(64).sum()
    ranges = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "view_trace.inner")
    assert len(ranges) == 5
    mapped = tr.epoch_ns(sp.t0)
    assert abs(ranges[-1] - mapped) < 1_000_000
    assert tr.epoch_ns(sp.t0) <= tr.epoch_ns(sp.t1)
    assert tr.epoch_ns(tr.anchor[0]) == tr.anchor[1]


def test_each_nvcc_run_is_counted_and_spanned(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(kbuild, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "kernels")
    before = kbuild.build.builds
    with obs_trace.span("outer") as outer:
        kbuild.build(["band_reclassify", "eps_affine"])
        kbuild.build(["band_reclassify"])          # built: no nvcc run
    assert kbuild.build.builds == before + 2
    assert sorted(c.attrs["source"] for c in outer.children) == [
        "band_reclassify", "eps_affine"]
    assert all(c.name == "kernels.build" and c.t1 >= c.t0
               for c in outer.children)
