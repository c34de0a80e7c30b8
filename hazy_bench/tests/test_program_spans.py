"""`program_spans.py` on the CPU at a tiny size: a traced run of each
cell with the program's tracer armed reads every number of its `METRICS`
that lists the cell, breaks the set-up down by its spans, pairs the
benchmark's commit ranges with the program's commit spans, and stays
correct."""
import time

import numpy as np
import pytest

from hazy_bench import program_spans, spec
from hazy_bench.tests.tiny import SIZES

BENCH = spec.load_benchmark()


@pytest.mark.parametrize("name", ["citeseer-k16.ingest", "forest-k7.mixed"])
def test_armed_traced_run_reads_every_program_number(name):
    cell = spec.cell(BENCH, name)
    res = program_spans.traced_run(BENCH, cell, 2**31 + 11, 1.5, "cpu",
                                   t0=time.perf_counter(),
                                   overrides=SIZES[cell["config"]])
    want = {m[0] for m in program_spans.METRICS
            if m[5] is None or name in m[5]}
    assert res["correct"] is True, res["checks"]
    assert res["program_missing"] == []
    assert set(res["program"]) == want
    p = {k: v["value"] for k, v in res["program"].items()}
    assert 2 <= p["host_syncs_per_commit"] <= 8
    assert p["union_rows_per_commit"] > 0
    assert 0 < p["sync_wait_ms_per_commit"]
    assert 0 < p["driver_host_ms_per_commit"]
    assert 0 < p["facade_build_s"] < res["metrics"].get(
        "setup_s", {"value": 1e9})["value"]
    pt = res["program_trace"]
    assert pt["commits_paired"] > 0 and pt["spans_kept"] > 0
    assert abs(pt["clock_residual_us"]) < 1000
    assert pt["builds"] == {"setup": pt["builds"]["setup"], "window": 0}
    parts = pt["setup_spans"]
    assert parts["facade.build"][0] == 1
    assert parts["facade.build"][1] == pytest.approx(p["facade_build_s"])
    for name in ("build.host_copy", "build.holder_M", "build.upload",
                 "build.reorganize"):
        assert parts[name][0] == 1 and parts[name][1] <= p["facade_build_s"]
    assert "idle_gaps_by_span" in res["breakdown"]


def test_innermost_span_wins():
    levels = [(np.array([10, 30]),
               np.array([20, 40]), ["c1", "c2"]),
              (np.array([0]),
               np.array([100]), ["root"])]
    assert program_spans.innermost(levels, np.array([5, 15, 25, 35, 150])) \
        == ["root", "c1", "root", "c2", None]


def test_setup_spans_sum_the_build_spans():
    from repro_torch.obs.trace import Span
    build = Span("facade.build", 0.0, 2.0, children=[
        Span("build.holder_M", 0.0, 0.5), Span("build.upload", 0.5, 1.0)])
    commit = Span("facade.commit", 3.0, 9.0, children=[
        Span("driver.round", 3.0, 9.0, children=[
            Span("kernels.build", 3.0, 8.0), Span("kernels.build", 3.0, 7.0),
            Span("driver.sync", 8.0, 9.0)])])
    assert program_spans.setup_spans([build, commit]) == {
        "facade.build": [1, 2.0], "build.holder_M": [1, 0.5],
        "build.upload": [1, 0.5], "kernels.build": [2, 9.0]}
