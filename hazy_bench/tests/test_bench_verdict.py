"""A run of a cell on the CPU at a tiny size: sound, it is correct; with
the timed path broken underneath (a fault planted in the program's
facade or driver), or with the control in the program's place, it is
not. Nothing here checks for a card."""
import subprocess
import sys

import numpy as np
import pytest

from hazy_bench import spec
from hazy_bench.run import FORBIDDEN
from hazy_bench.tests.tiny import run_cpu

BENCH = spec.load_benchmark()


@pytest.mark.parametrize("name", ["citeseer-k16.ingest", "forest-k7.mixed"])
def test_sound_run_is_correct(name):
    res = run_cpu(name)
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"
    assert res["checks"]["label_mismatches"]["value"] == 0
    assert ({m["name"] for m in spec.metrics_for(BENCH, name, 0)}
            == set(res["metrics"]))


def _state_unchanged(monkeypatch):
    from repro_torch.core.sharded import ShardedMultiViewHazy
    monkeypatch.setattr(ShardedMultiViewHazy, "apply_models",
                        lambda self, state, W, b: state)


def _half_batch(monkeypatch):
    from repro_torch.core.facade import ShardedFacade
    real = ShardedFacade.insert_examples
    monkeypatch.setattr(ShardedFacade, "insert_examples",
                        lambda self, ids, labels: real(
                            self, ids[: len(ids) // 2],
                            labels[: len(labels) // 2]))


def _point_answer_altered(monkeypatch):
    from repro_torch.core.facade import ShardedFacade
    real = ShardedFacade.point_labels_of
    calls = [0]

    def altered(self, entity_id):
        labels, hows = real(self, entity_id)
        calls[0] += 1
        if calls[0] % 97 == 0:
            labels = np.array(labels)
            labels[0] = -labels[0]
        return labels, hows
    monkeypatch.setattr(ShardedFacade, "point_labels_of", altered)


def _members_answer_altered(monkeypatch):
    from repro_torch.core.facade import ShardedFacade
    real = ShardedFacade.members

    def altered(self, view=0, positive=True):
        return real(self, view, positive)[1:]
    monkeypatch.setattr(ShardedFacade, "members", altered)


@pytest.mark.parametrize("name,fault", [
    ("citeseer-k16.ingest", _state_unchanged),
    ("forest-k7.mixed", _state_unchanged),
    ("citeseer-k16.ingest", _half_batch),
    ("forest-k7.mixed", _half_batch),
    ("forest-k7.mixed", _point_answer_altered),
    ("citeseer-k16.ingest", _members_answer_altered),
])
def test_fault_makes_the_run_incorrect(monkeypatch, name, fault):
    fault(monkeypatch)
    res = run_cpu(name)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", ["citeseer-k16.ingest", "forest-k7.mixed"])
def test_control_is_not_correct(name):
    from hazy_bench import control, judge
    from hazy_bench.tests.tiny import SIZES
    cell = spec.cell(BENCH, name)
    prog, low, limits = control.readings(BENCH, cell, 9, 1.5, "cpu",
                                         SIZES[cell["config"]])
    assert judge.verdict(prog, limits)
    assert not judge.verdict(low, limits)


@pytest.mark.parametrize("module,owner,name", [
    ("repro_torch.core.sharded", "ShardedMultiViewHazy", "_do_reorg"),
    ("repro_torch.core.sharded", "ShardedMultiViewHazy", "apply_models"),
    ("repro_torch.kernels.band_reclassify.kernel", None,
     "multiview_band_reclassify"),
])
def test_traced_run_stops_where_a_hook_is_gone(monkeypatch, module, owner,
                                               name):
    """A traced run wraps these names of the program; renamed away, the
    run stops with the name, before a per-layer metric reads nothing."""
    import importlib
    target = importlib.import_module(module)
    monkeypatch.delattr(getattr(target, owner) if owner else target, name)
    with pytest.raises(RuntimeError, match=name):
        run_cpu("forest-k7.mixed", seconds=1.0, trace=1)


def test_traced_run_names_the_metrics_that_read_nothing():
    """On the CPU nothing runs on a device: the device's metrics read
    nothing, and the run says which (`run.main` then exits non-zero)."""
    res = run_cpu("forest-k7.mixed", seconds=1.0, trace=1)
    assert {"mv_band_reclassify_roofline", "device_idle_share"} <= set(
        res["silent"])
    assert "sgd_ms_per_commit" in res["metrics"]


def _top_level_modules(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return set(out.split())


def test_run_path_loads_no_jax_and_no_reference_package():
    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            "from hazy_bench.tests.tiny import run_cpu\n"
            "run_cpu('forest-k7.mixed', seconds=1.0, trace=1)\n"
            "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    found = _top_level_modules(code)
    assert "repro_torch" in found
    assert not found & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = ['.']\n"
            "import hazy_bench.judge, hazy_bench.reference.control\n"
            "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    found = _top_level_modules(code)
    assert not found & {"repro_torch", *FORBIDDEN}


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_at_the_cells_own_size(card, name):
    """On the card, at the configuration's own size and a short window:
    the program keeps the limits, the control does not."""
    from hazy_bench import control, judge
    cell = spec.cell(BENCH, name)
    prog, low, limits = control.readings(BENCH, cell, 2**31 + 3, 10.0, card)
    assert judge.verdict(prog, limits)
    assert not judge.verdict(low, limits)
