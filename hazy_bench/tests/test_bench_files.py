import json

import numpy as np
import pytest
import torch

from hazy_bench import corpus, generator, spec
from hazy_bench.reference import labels as L
from hazy_bench.reference.sgd import replay

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.cell(BENCH, name)
    cfg = spec.config(BENCH, cell["config"])
    mix = spec.traffic(cell["traffic"])
    assert cfg["name"] == cell["config"] and mix["name"] == cell["traffic"]
    assert set(cfg["checks"]) == {"label_mismatches", "model_gap"}
    for trace in (0, 1):
        for m in spec.metrics_for(BENCH, name, trace):
            assert callable(spec.reader(m["name"]))


def test_every_metric_has_a_reader_and_every_file_a_user():
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.stem for p in (spec.BENCH / "metrics").glob("*.py")}
    assert names == files
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    mixes = {p.stem for p in (spec.BENCH / "traffic").glob("*.json")}
    assert {w["traffic"] for w in BENCH["workloads"]} <= mixes
    for c in BENCH["configs"]:
        json.loads((spec.ROOT / c["file"]).read_text())


def _tiny(name):
    cfg = spec.config(BENCH, name)
    return dict(cfg, rows=4096)


@pytest.mark.parametrize("name", ["citeseer-k16", "forest-k7"])
def test_corpus_repeats_for_a_seed(name):
    cfg = _tiny(name)
    F1, c1 = corpus.make(cfg, 2**31 + 7, "cpu")
    F2, c2 = corpus.make(cfg, 2**31 + 7, "cpu")
    F3, _ = corpus.make(cfg, 2**31 + 8, "cpu")
    assert np.array_equal(F1, F2) and np.array_equal(c1, c2)
    assert not np.array_equal(F1, F3)
    assert F1.dtype == np.float32 and F1.shape == (4096, cfg["width"])
    norm = (np.abs(F1).sum(1) if cfg["norm"] == "l1"
            else np.linalg.norm(F1, axis=1))
    assert np.allclose(norm, 1.0, atol=1e-5)
    assert set(np.unique(c1)) == set(range(cfg["views"]))


def test_forest_classes_come_in_covertypes_shares():
    cfg = dict(spec.config(BENCH, "forest-k7"), rows=200_000)
    _, cls = corpus.make(cfg, 2**31 + 9, "cpu")
    want = np.asarray(cfg["class_counts"], np.float64)
    got = np.bincount(cls, minlength=cfg["views"]) / cls.size
    assert np.allclose(got, want / want.sum(), atol=3e-3)
    assert got.argmax() == 1 and got.min() < 0.01


@pytest.mark.parametrize("mix", ["ingest", "mixed"])
def test_stream_repeats_for_a_seed(mix):
    m = spec.traffic(mix)
    cls = np.arange(1000) % 7

    def take(seed, n=3000):
        s = generator.stream(m, cls, 7, 0.02, seed)
        return [repr(next(s)) for _ in range(n)]

    assert take(2**31 + 5) == take(2**31 + 5)
    assert take(2**31 + 5) != take(2**31 + 6)
    ops = [next(generator.stream(m, cls, 7, 0.0, 3)) for _ in range(1)]
    assert ops[0][0] in ("commit", "point", "members")


def test_stream_mix_and_commits():
    m = spec.traffic("mixed")
    cls = np.arange(5000) % 7
    s = generator.stream(m, cls, 7, 0.0, 11)
    kinds = {"commit": 0, "point": 0, "members": 0}
    rows = 0
    for _ in range(20000):
        op = next(s)
        kinds[op[0]] += 1
        if op[0] == "commit":
            assert len(op[1]) == m["commit_rows"]
            assert all(cls[i] == c for i, c in zip(op[1], op[2]))
            rows += len(op[1])
    share = kinds["point"] / (kinds["point"] + kinds["members"] + rows)
    assert abs(share - 0.55) < 0.02
    ing = generator.stream(spec.traffic("ingest"), cls, 7, 0.0, 11)
    seq = [next(ing)[0] for _ in range(34)]
    assert seq[:17] == ["commit"] * 16 + ["members"]


def test_replay_equals_a_direct_computation():
    rng = np.random.default_rng(0)
    n, d, k = 300, 24, 5
    F = rng.random((n, d), dtype=np.float32)
    commits = [(list(rng.integers(0, n, 8)), list(rng.integers(0, k, 8)))
               for _ in range(20)]
    seen = []
    W, b = replay(F, commits, k, lr=0.1, l2=1e-4,
                  visit=lambda c, W, b: seen.append(c))
    assert seen == list(range(21))
    W2 = np.zeros((k, d), np.float64)
    b2 = np.zeros(k)
    for ids, classes in commits:
        for i, c in zip(ids, classes):
            for v in range(k):
                y = 1.0 if v == c else -1.0
                z = float(np.dot(W2[v], F[i])) - b2[v]
                g = -y if y * z < 1.0 else 0.0
                W2[v] = W2[v] * (1 - 0.1 * 1e-4) - 0.1 * g * F[i]
                b2[v] = b2[v] + 0.1 * g
    assert np.allclose(W, W2, rtol=1e-4, atol=1e-5)
    assert np.allclose(b, b2, rtol=1e-6, atol=1e-9)
    table = L.Table(F, "cpu")
    z = table.margins(W, b).numpy()
    want = (F.astype(np.float64) @ W.astype(np.float64).T - b).T
    assert np.allclose(z, want)
    zp, tol = L.point_margins(F, [3, 7], W, b)
    assert np.allclose(zp, z[:, [3, 7]].T) and (tol > 0).all()


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0000001])
    y = L.tf32(x)
    assert y.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -3.0]
    assert np.array_equal(L.tf32_np(x.numpy()), y.numpy())
