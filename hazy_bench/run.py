"""The benchmark of the PyTorch and CUDA port (`repro_torch`): k one-vs-all
classification views kept exact under a stream of training inserts and
reads, through the port's facade `ShardedFacade`.

Run from the root of a checkout, on a machine with the cards the cell
asks for:

    python3 hazy_bench/run.py --workload citeseer-k16.ingest --seed 7 \
        --seconds 30 --trace 0

A run draws its table and its operations from the seed, builds the facade
(`make_sharded_facade`), replays a warm-up prefix of the stream, measures
a closed loop for `--seconds`, then frees the program and holds what it
answered to the plain reference (`judge.py`). The last line of standard
output is one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error. With `--trace 1` the metrics are
the cell's per-layer metrics, read from spans, the program's counters and
a profiled slice at the end of the window. Kernels are built into the
checkout's `build/kernels/` at first use.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for _var, _dir in (("TRITON_CACHE_DIR", "build/triton"),
                   ("TORCH_EXTENSIONS_DIR", "build/torch_extensions")):
    os.environ[_var] = str(ROOT / _dir)
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"             # one client, few threads: steadier
if str(BENCH) in sys.path:             # our module names are not top-level
    sys.path.remove(str(BENCH))
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
PROFILE_S = 3.0                        # the profiled slice, at most


def _cpu_times() -> tuple:
    """(steal, total) jiffies of the machine's CPUs from `/proc/stat`:
    time the hypervisor gave the machine's CPUs to others. Beside each run
    it witnesses the host's speed; (0, 0) where there is no such file."""
    try:
        with open("/proc/stat") as f:
            vals = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return 0, 0
    return (vals[7] if len(vals) > 7 else 0), sum(vals[:8])


def _pin_main_thread():
    """Keep the client's thread on one CPU, the last of those it may use
    (a fixed choice), so the window's host work does not migrate; the
    CUDA runtime's own threads keep the rest. Returns the CPU or None."""
    try:
        cpus = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {cpus[-1]})   # 0: the calling thread
        return cpus[-1]
    except (AttributeError, OSError):
        return None


def _counters(drv) -> dict:
    return {"reorgs": drv.skiing.reorgs, "overflows": drv.overflows,
            "total_incremental": drv.skiing.total_incremental}


def measure(bench, cell, seed, seconds, trace, device, t0=T0,
            overrides=None):
    """Set-up, warm-up and the window of one run. Returns (records for
    the metrics, the program's outputs, every commit, the table, the
    configuration); the program is freed before it returns."""
    import torch
    from hazy_bench import corpus, devtrace, generator, spec
    from hazy_bench.client import Client
    from repro_torch.core.facade import make_sharded_facade

    cfg = dict(spec.config(bench, cell["config"]), **(overrides or {}))
    mix = spec.traffic(cell["traffic"])
    cuda = torch.device(device).type == "cuda"
    stamps = {"imports": time.perf_counter()}
    F, classes = corpus.make(cfg, seed, device)
    stamps["table"] = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fac = make_sharded_facade(
        F, cfg["views"], p=float(cfg["p"]), q=float(cfg["q"]), lr=cfg["lr"],
        l2=cfg["l2"], alpha=cfg["alpha"], cap_frac=cfg["cap_frac"],
        device=device)
    ops = generator.stream(mix, classes, cfg["views"], cfg["label_noise"],
                         seed)
    client = Client(fac, ops, members_share=mix["members_checked_share"],
                    seed=seed, spans=bool(trace))
    stamps["facade"] = time.perf_counter()
    client.warmup(cfg["warmup_rows"])
    if trace:
        client.warm_profiler()
    stamps["warm-up"] = time.perf_counter()
    drv = fac.driver
    c0, commits0 = _counters(drv), len(client.commits)
    setup_s = time.perf_counter() - t0

    profile_s = min(PROFILE_S, seconds / 2) if trace else 0.0
    cpu = _pin_main_thread() if cuda else None
    gc.collect()
    gc.freeze()                        # set-up's objects: never scanned again
    gc.disable()                       # no collector pause inside the window
    steal0 = _cpu_times()
    try:
        window_s, prof, slice_s = client.window(seconds, profile_s)
    finally:
        gc.enable()
        gc.unfreeze()
    steal1 = _cpu_times()
    c1 = _counters(drv)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    out = client.outputs()
    cut = client.slice_from
    marks = [t0, *stamps.values()]
    rec = {"setup_s": setup_s, "window_s": window_s, "rows": client.rows,
           "setup_parts": {k: b - a for k, a, b in
                           zip(stamps, marks, marks[1:])},
           "commits": len(client.commits) - commits0,
           "lat": client.lat,
           "counters": {m: c1[m] - c0[m] for m in c0},
           "device": {"kind": (torch.cuda.get_device_name(0) if cuda
                               else "cpu"),
                      "count": cell["chips"], "memory_peak_bytes": peak},
           "host": {"cpu": cpu, "steal_share": (
               (steal1[0] - steal0[0]) / max(steal1[1] - steal0[1], 1))},
           "spans": None, "trace": None}
    if trace:
        rec["spans"] = {"insert_s": client.insert_s[:cut["commit"]],
                        "apply_s": client.apply_s[:cut["commit"]],
                        "point_s": client.lat["point"][:cut["point"]],
                        "commit_s": client.lat["commit"][:cut["commit"]],
                        "members_s": client.lat["members"][:cut["members"]],
                        "reorg_device_s": [a.elapsed_time(b) / 1e3 for a, b
                                           in client.reorg_events]}
        rec["trace"] = (devtrace.reduce(prof, slice_s, client.launches)
                        if prof is not None else None)
    commits = client.commits
    del fac, drv, client, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec, out, commits, F, cfg


def run_cell(bench, cell, seed, seconds, trace, device, t0=T0,
             overrides=None, log=sys.stderr):
    """One run: measure, judge, read the metrics. Returns the result."""
    import numpy as np
    from hazy_bench import judge, spec
    from hazy_bench.reference.labels import Table

    rec, out, commits, F, cfg = measure(bench, cell, seed, seconds, trace,
                                        device, t0, overrides)
    t_judge = time.perf_counter()
    table = Table(F, device)
    numbers = judge.judge(F, table, commits, cfg, [out])[0]
    del table
    t_judge = time.perf_counter() - t_judge
    correct = judge.verdict(numbers, cfg["checks"])
    metrics, silent = {}, []
    for m in spec.metrics_for(bench, cell["name"], bool(trace)):
        v = spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            silent.append(m["name"])
    lat = rec["lat"]
    attempted = sum(len(v) for v in lat.values())
    result = {"correct": correct, "attempted": attempted,
              "failed": numbers["parts"]["answers_wrong"],
              "metrics": metrics,
              "device": {"platform": "gpu" if rec["device"]["kind"] != "cpu"
                         else "cpu", **rec["device"]}}
    t = rec["trace"]
    if t is not None:
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {
            "device_ops": [[n[:96], v] for n, v in t["device_ops"][:10]],
            "idle_gaps": t["idle_gaps"][:10]}
    result["silent"] = silent          # taken out again before printing
    result["checks"] = {m: {"value": numbers[m], "limit": cfg["checks"][m]}
                        for m in judge.NUMBERS}
    print(f"cell {cell['name']} seed {seed}: window {rec['window_s']:.3f} s,"
          f" {rec['commits']} commits, {rec['rows']} rows, "
          f"{len(lat['point'])} point reads, {len(lat['members'])} members "
          f"reads; counters {rec['counters']}; set-up {rec['setup_s']:.3f} s"
          f" {({k: round(v, 3) for k, v in rec['setup_parts'].items()})}; "
          f"judged in {t_judge:.3f} s; host: imports "
          f"{rec['setup_parts']['imports']:.3f} s, steal share "
          f"{rec['host']['steal_share']:.4f} in the window, client on CPU "
          f"{rec['host']['cpu']}", file=log)
    for kind, v in lat.items():
        if v:
            q = np.percentile(v, [50, 95, 99]) * 1e3
            print(f"{kind}: {len(v)} calls, ms p50 {q[0]:.4f} p95 {q[1]:.4f}"
                  f" p99 {q[2]:.4f} max {max(v) * 1e3:.4f}", file=log)
    if t is not None:
        print(f"trace: {t['device_events']} device operations; ranges "
              f"{t['range_counts']}; kernels {t['kernels']}; launches "
              f"windowed {len(t['launches'])}", file=log)
    print(f"checked: {numbers['parts']}", file=log)
    for m in judge.NUMBERS:
        print(f"check {m} {numbers[m]!r} limit {cfg['checks'][m]!r}",
              file=log)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("no src/repro_torch beside the benchmark: nothing to measure",
              file=sys.stderr)
        return 2
    from hazy_bench import spec
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(bench, cell, args.seed, args.seconds, args.trace,
                      "cuda")
    silent = result.pop("silent")
    if silent:
        print(f"{args.workload} lists {silent}, which read nothing in this "
              f"run: a hook of the benchmark no longer reaches the program's"
              f" work", file=sys.stderr)
        return 4
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"the run loaded {found}: it may load none of {FORBIDDEN}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
