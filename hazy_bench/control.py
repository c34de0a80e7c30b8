"""The control's readings beside the program's, seed by seed, at a cell's
own size and load: each seed runs the cell as `run.py` does (a short
window), then the control (`reference/control.py`) answers the very
operations the program answered, and one replay of the reference judges
both. The control has to fail a limit the program keeps.

    python3 hazy_bench/control.py --workload citeseer-k16.ingest \
        --seconds 10 --seeds 11 12 13

One JSON line a seed on standard output."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
if str(BENCH) in sys.path:
    sys.path.remove(str(BENCH))
sys.path[:0] = [str(BENCH.parent), str(BENCH.parent / "src")]
from hazy_bench.run import measure  # noqa: E402  (sets the caches up)


def readings(bench, cell, seed, seconds, device, overrides=None):
    """({program's numbers}, {control's numbers}) of one seed."""
    from hazy_bench import judge
    from hazy_bench.reference import control
    from hazy_bench.reference.labels import Table
    _, out, commits, F, cfg = measure(bench, cell, seed, seconds, 0, device,
                                      time.perf_counter(), overrides)
    table = Table(F, device)
    ctl = control.answers(F, table, dict(out, commits=commits), cfg)
    prog, low = judge.judge(F, table, commits, cfg, [out, ctl])
    return prog, low, cfg["checks"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from hazy_bench import judge, spec
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    for seed in args.seeds:
        prog, low, limits = readings(bench, cell, seed, args.seconds, "cuda")
        print(json.dumps({
            "workload": cell["name"], "seed": seed, "limits": limits,
            "program": prog, "control": low,
            "program_correct": judge.verdict(prog, limits),
            "control_correct": judge.verdict(low, limits)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
