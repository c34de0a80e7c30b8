"""A traced run of a cell with the program's own tracer armed: the spans
and counters `repro_torch` keeps inside its view engine (an `obs.Tracer`
handed to `make_sharded_facade`), read into per-layer numbers, and the
idle gaps of the profiled slice put down to the innermost program span.

Run from the root of a checkout, on a machine with the cell's card:

    python3 hazy_bench/program_spans.py --workload forest-k7.mixed \\
        --seed 7 --seconds 51

It is `run.py --trace 1` (the same set-up, window, profiled slice and
judge, through `run.run_cell`) with four of the harness's names wrapped in
this process: `make_sharded_facade` gets the tracer, which keeps the
set-up's span trees; `Client.window` and `Client._profile_start` snapshot
its registry at the window's start, the slice's start and the window's
end, and keep the slice's span trees; `devtrace.reduce` lays those trees
on the profiler's timeline through the tracer's clock anchor. Its last
line is `run.py`'s result with `program` (the numbers of `METRICS`),
`program_trace` (the clock residual, kernel builds, the set-up's spans)
and `breakdown.idle_gaps_by_span` added. It exits 4 where a number of
`METRICS` that lists the cell reads nothing, 3 where the run loaded a
module `run.py` forbids.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
if str(BENCH) in sys.path:             # our module names are not top-level
    sys.path.remove(str(BENCH))
sys.path[:0] = [str(BENCH.parent), str(BENCH.parent / "src")]

from hazy_bench import run  # noqa: E402  (sets the run's environment)

import numpy as np  # noqa: E402


def _hist(snap, name):
    h = snap["histograms"].get(f"span.{name}.seconds")
    return (h["count"], h["sum"]) if h else (0, 0.0)


def _delta(a, b, name):
    """(calls, seconds) of span `name` between registry snapshots a, b."""
    (ca, sa), (cb, sb) = _hist(a, name), _hist(b, name)
    return cb - ca, sb - sa


def _counter(a, b, name):
    return b["counters"].get(name, 0) - a["counters"].get(name, 0)


def host_syncs_per_commit(s):
    commits, _ = _delta(s["window"], s["end"], "facade.commit")
    syncs, _ = _delta(s["window"], s["end"], "driver.sync")
    return syncs / commits if commits else None


def sync_wait_ms_per_commit(s):
    commits, _ = _delta(s["window"], s["slice"], "facade.commit")
    _, wait = _delta(s["window"], s["slice"], "driver.sync")
    return wait / commits * 1e3 if commits else None


def driver_host_ms_per_commit(s):
    commits, _ = _delta(s["window"], s["slice"], "facade.commit")
    if not commits:
        return None
    host = sum(sign * _delta(s["window"], s["slice"], name)[1]
               for sign, name in ((1, "driver.round"), (-1, "driver.sync"),
                                  (-1, "driver.reorganize")))
    return host / commits * 1e3


def union_rows_per_commit(s):
    commits, _ = _delta(s["window"], s["end"], "facade.commit")
    return (_counter(s["window"], s["end"], "kernels.union_rows") / commits
            if commits else None)


def point_read_wait_us(s):
    reads, _ = _delta(s["window"], s["slice"], "facade.point_read")
    _, wait = _delta(s["window"], s["slice"], "read.sync")
    return wait / reads * 1e6 if reads else None


def facade_build_s(s):
    calls, seconds = _hist(s["end"], "facade.build")
    return seconds if calls else None


def setup_spans(trees) -> dict:
    """The set-up's breakdown: [calls, seconds] of each `facade.build`,
    `build.*` and `kernels.build` span in the kept trees (the `nvcc` runs
    overlap, so their seconds add up past the wall time they take)."""
    out = {}
    for t in trees:
        for sp in t.walk():
            if sp.name.startswith(("facade.build", "build.", "kernels.")):
                c = out.setdefault(sp.name, [0, 0.0])
                c[0] += 1
                c[1] += sp.duration_s
    return out


# name, unit, source, layer, moves, workloads (None: every cell), reader
METRICS = [
    ("host_syncs_per_commit", "syncs", "program_counter", "driver",
     "commit_p95_ms", None, host_syncs_per_commit),
    ("sync_wait_ms_per_commit", "ms", "program_span", "driver",
     "commit_p95_ms", None, sync_wait_ms_per_commit),
    ("driver_host_ms_per_commit", "ms", "program_span", "driver",
     "commit_p95_ms", None, driver_host_ms_per_commit),
    ("union_rows_per_commit", "rows", "program_counter", "kernels",
     "commit_p95_ms", None, union_rows_per_commit),
    ("point_read_wait_us", "us", "program_span", "reads",
     "insert_rows_per_s", ["forest-k7.mixed"], point_read_wait_us),
    ("facade_build_s", "s", "program_span", "facade", "setup_s", None,
     facade_build_s),
]


def _span_levels(tracer, roots):
    """Per nesting depth, deepest first: (starts, ends, names) of the
    finished spans under `roots`, in epoch ns, sorted by start."""
    levels = {}
    stack = [(r, 0) for r in roots]
    while stack:
        sp, depth = stack.pop()
        if sp.t1 is None:
            continue
        levels.setdefault(depth, []).append(
            (tracer.epoch_ns(sp.t0), tracer.epoch_ns(sp.t1), sp.name))
        stack.extend((c, depth + 1) for c in sp.children)
    out = []
    for depth in sorted(levels, reverse=True):
        rs = sorted(levels[depth])
        out.append((np.array([r[0] for r in rs], np.int64),
                    np.array([r[1] for r in rs], np.int64),
                    [r[2] for r in rs]))
    return out


def innermost(levels, t: np.ndarray) -> list:
    """The innermost span's name at each epoch-ns time; None outside."""
    names = [None] * len(t)
    for starts, ends, rn in levels:
        j = np.searchsorted(starts, t, side="right") - 1
        hit = (j >= 0) & (ends[np.maximum(j, 0)] > t)
        for i in np.flatnonzero(hit):
            if names[i] is None:
                names[i] = rn[j[i]]
    return names


def slice_spans(prof, tracer) -> dict:
    """The kept trees against the profiled slice: the device's idle gaps
    by the innermost program span at each gap's middle, and the clock
    residual, the median of (the benchmark's `commit` range start − the
    mapped `facade.commit` start) in us."""
    from torch.autograd import DeviceType

    from hazy_bench import devtrace
    from hazy_bench.client import RANGE
    dev, commit_ranges = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(RANGE):
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name == RANGE + "commit":
            commit_ranges.append(e.start_ns())
    busy = devtrace._union(np.array(dev, np.int64).reshape(-1, 2))
    levels = _span_levels(tracer, tracer.kept)
    gaps = {}
    if len(busy) > 1:
        g0, g1 = busy[:-1, 1], busy[1:, 0]
        for n, d in zip(innermost(levels, (g0 + g1) // 2), g1 - g0):
            key = n or "no span"
            gaps[key] = gaps.get(key, 0) + int(d)
    starts = np.sort(np.array([tracer.epoch_ns(t.t0) for t in tracer.kept
                               if t.name == "facade.commit"], np.int64))
    residual = []
    if len(starts):
        for r in commit_ranges:
            j = int(np.searchsorted(starts, r))
            near = [starts[i] for i in (j - 1, j) if 0 <= i < len(starts)]
            residual.append(r - min(near, key=lambda m: abs(r - m)))
    return {"idle_gaps_by_span": sorted(([n, v / 1e9] for n, v in
                                         gaps.items()), key=lambda x: -x[1]),
            "clock_residual_us": (float(np.median(residual)) / 1e3
                                  if residual else None),
            "commits_paired": len(residual), "spans_kept": len(tracer.kept)}


def traced_run(bench, cell, seed, seconds, device, t0=T0, overrides=None,
               log=sys.stderr) -> dict:
    """`run.run_cell(..., trace=1)` with the program's tracer armed; the
    result gains `program`, `program_trace` and
    `breakdown.idle_gaps_by_span`."""
    from hazy_bench import devtrace
    from hazy_bench.client import Client
    from repro_torch.core import facade
    from repro_torch.kernels import build as kbuild
    from repro_torch.obs import MetricsRegistry, Tracer

    tracer = Tracer(MetricsRegistry())
    snaps, builds, found = {}, {}, {}
    make, window = facade.make_sharded_facade, Client.window
    profile_start, reduce = Client._profile_start, devtrace.reduce

    def snap(key):
        snaps[key] = tracer.snapshot()
        builds[key] = kbuild.build.builds

    def armed_make(*a, **kw):
        tracer.keep = True              # the set-up's trees, till the window
        return make(*a, tracer=tracer, **kw)

    def armed_window(self, *a, **kw):
        found["setup_spans"] = setup_spans(tracer.kept)
        tracer.keep = False
        tracer.kept.clear()
        snap("window")
        try:
            return window(self, *a, **kw)
        finally:
            tracer.keep = False
            snap("end")

    def armed_profile_start(self):
        snap("slice")
        tracer.keep = True
        return profile_start(self)

    def armed_reduce(prof, *a, **kw):
        found.update(slice_spans(prof, tracer))
        return reduce(prof, *a, **kw)

    saved = [(facade, "make_sharded_facade", armed_make),
             (Client, "window", armed_window),
             (Client, "_profile_start", armed_profile_start),
             (devtrace, "reduce", armed_reduce)]
    old = [(obj, name, getattr(obj, name)) for obj, name, _ in saved]
    for obj, name, new in saved:
        setattr(obj, name, new)
    try:
        result = run.run_cell(bench, cell, seed, seconds, 1, device, t0,
                              overrides, log)
    finally:
        for obj, name, value in old:
            setattr(obj, name, value)
    program, missing = {}, []
    for name, unit, _, _, _, cells, read in METRICS:
        if cells is not None and cell["name"] not in cells:
            continue
        value = read(snaps) if {"window", "slice", "end"} <= set(snaps) \
            else None
        if value is None:
            missing.append(name)
        else:
            program[name] = {"value": value, "unit": unit}
    result["program"] = program
    result["program_missing"] = missing
    result.setdefault("breakdown", {})["idle_gaps_by_span"] = \
        found.get("idle_gaps_by_span", [])[:12]
    result["program_trace"] = {
        "clock_residual_us": found.get("clock_residual_us"),
        "commits_paired": found.get("commits_paired", 0),
        "spans_kept": found.get("spans_kept", 0),
        "setup_spans": found.get("setup_spans", {}),
        "builds": {"setup": builds.get("window"),
                   "window": (builds["end"] - builds["window"]
                              if "end" in builds else None)}}
    pt = result["program_trace"]
    print(f"program: {program}; clock residual {pt['clock_residual_us']} us"
          f" over {pt['commits_paired']} commits; kernel builds in set-up "
          f"{pt['builds']['setup']}, in the window {pt['builds']['window']}"
          f"; set-up spans {pt['setup_spans']}", file=log)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from hazy_bench import spec
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = traced_run(bench, cell, args.seed, args.seconds, "cuda")
    silent, missing = result.pop("silent"), result.pop("program_missing")
    if silent or missing:
        print(f"{args.workload}: {silent + missing} read nothing in this "
              f"run", file=sys.stderr)
        return 4
    found = sorted({m.split(".")[0] for m in sys.modules} & set(run.FORBIDDEN))
    if found:
        print(f"the run loaded {found}: it may load none of {run.FORBIDDEN}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
