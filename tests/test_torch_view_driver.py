"""The port's view-serving driver (`repro_torch.launch.view_driver`) and
`serve.py --mode view` against the reference's driver, on the CPU.

  * `make_topic_docs` bit for bit;
  * `make_backbone_encoder`'s features of 48 documents against the
    reference encoder's, the reference's smoke-twin params carried across
    (`core.convert.params_from_reference`): within atol 5e-3, rtol 0, on
    unit-norm rows of 128 (a typical entry about 0.05). The twin computes
    in bf16 and the frameworks sum in other orders: the port reads
    2.19e-3 at most. A pooling mistake reads 1.11e-2 (the mean over all
    but the last token), so this limit rejects it. Leaving out the bf16
    rounding of the pooled means reads 1.92e-3, within the frameworks'
    own difference, so no elementwise limit on this test can see it;
  * `serve_view` at a small size ends in `check_consistent()` and prints
    "view exact", and so does `serve.main(["--mode", "view", ...])`;
  * `--sql` runs the same workload through the port's relational front
    end (`repro_torch.rdbms`, ROADMAP's `rdbms/` item) and ends in "view
    exact"; `--mode sql` runs statements; `serve` without `--mode` serves
    the view, as the reference's does."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402

from repro.configs import smoke_config as jax_smoke         # noqa: E402
from repro.launch import view_driver as RV                  # noqa: E402
from repro.models import build as jax_build                 # noqa: E402
from repro.models import steps as JS                        # noqa: E402

from repro_torch.configs import smoke_config                # noqa: E402
from repro_torch.core.convert import params_from_reference  # noqa: E402
from repro_torch.launch import serve                        # noqa: E402
from repro_torch.launch import view_driver as TV            # noqa: E402

ARCH = "tinyllama-1.1b"


@pytest.mark.parametrize("n_docs,doc_len,seed", [(4000, 32, 0), (37, 9, 5)])
def test_topic_docs_bit_for_bit(n_docs, doc_len, seed):
    cfg = smoke_config(ARCH)
    docs, topic = TV.make_topic_docs(cfg, n_docs, doc_len, seed)
    ref_docs, ref_topic = RV.make_topic_docs(jax_smoke(ARCH), n_docs,
                                             doc_len, seed)
    assert docs.dtype == ref_docs.dtype == np.int32
    assert np.array_equal(docs, ref_docs) and np.array_equal(topic,
                                                             ref_topic)


def test_encoder_matches_reference():
    ref_encode, ref_cfg = RV.make_backbone_encoder(ARCH, batch=16)
    jp = JS.init_train_state(jax_build(jax_smoke(ARCH)))["params"]
    params = params_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                   smoke_config(ARCH), device="cpu")
    encode, cfg = TV.make_backbone_encoder(ARCH, batch=16, params=params,
                                           device="cpu")
    assert cfg.name == ref_cfg.name
    docs, _ = TV.make_topic_docs(cfg, 48, 32, seed=3)
    F, want = encode(docs), ref_encode(docs)
    assert F.shape == want.shape == (48, 2 * cfg.d_model)
    assert F.dtype == want.dtype == np.float32
    np.testing.assert_allclose(F, want, rtol=0, atol=5e-3)
    np.testing.assert_allclose(np.linalg.norm(F, axis=1), 1.0, rtol=1e-5)


def test_serve_view_small_on_cpu(capsys):
    view = TV.serve_view(requests=400, docs=300, doc_len=16, device="cpu")
    out = capsys.readouterr().out
    assert "view exact" in out and "req/s" in out
    assert view.engine.device.type == "cpu"
    assert view.engine.policy == "hybrid" and view.engine.check_consistent()
    truth = np.where(view.F @ view.model.w - view.model.b >= 0, 1, -1)
    assert view.all_members() == int((truth == 1).sum())


def test_serve_mode_view_runs_on_cpu(capsys):
    view = serve.main(["--mode", "view", "--requests", "150",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "encoded 4000 docs" in out and "view exact" in out
    assert view.F.shape == (4000, 2 * smoke_config(ARCH).d_model)


def test_sql_modes_name_the_rdbms_item(capsys):
    """The SQL modes run the `rdbms/` item: `--sql` serves the workload as
    a statement stream and ends in the golden invariant."""
    ex = TV.main(["--sql", "--device", "cpu", "--requests", "150"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("view exact ✓") and "stmt/s" in out
    facade = ex.catalog.view("topic").facade
    assert facade.view.engine.device.type == "cpu"
    assert facade.view.engine.check_consistent()
    assert sum(facade.tier_hits.values()) > 0 and ex.log.commits > 0
    assert ex.catalog.tables["docs"].features.shape == (
        4000, 2 * smoke_config(ARCH).d_model)


def test_sql_small_matches_a_direct_view(capsys):
    """`serve_sql` at a small size: its labels and counts equal a direct
    `ClassificationView` fed the same examples in the same groups."""
    ex = TV.serve_sql(requests=300, docs=200, doc_len=12, group_commit=8,
                      device="cpu")
    assert "view exact" in capsys.readouterr().out
    ex.execute_one("COMMIT")                 # the stream's last group
    facade = ex.catalog.view("topic").facade
    from repro_torch.core import ClassificationView
    direct = ClassificationView(ex.catalog.tables["docs"].features,
                                method="svm", policy="hybrid",
                                norm=(2.0, 2.0), lr=0.1, buffer_frac=0.01,
                                device="cpu")
    group = []
    for rec in ex.log.history:
        if rec.op == "commit":
            direct.insert_examples([r.entity_id for r in group],
                                   [r.label for r in group], batched=True)
            group = []
        else:
            group.append(rec)
    assert not group
    assert np.array_equal(direct.model.w, facade.view.model.w)
    assert direct.all_members() == facade.view.all_members()
    assert [direct.label(i) for i in range(200)] == \
        [facade.view.label(i) for i in range(200)]


def test_serve_mode_defaults_to_view(monkeypatch):
    """`serve` without `--mode` hands its requests to the view driver, as
    the reference's `--mode` default (`view`) does; `--mode view` itself
    runs in `test_serve_mode_view_runs_on_cpu`."""
    monkeypatch.setattr(TV, "main", lambda argv: ("view", argv))
    assert serve.main(["--requests", "40", "--device", "cpu"]) == \
        ("view", ["--requests", "40", "--device", "cpu"])
