"""A cell at a size the CPU holds in seconds: every number of the cell's
configuration but its rows and warm-up."""
import time

from hazy_bench import run, spec

SIZES = {"citeseer-k16": dict(rows=16384, warmup_rows=16384),
         "forest-k7": dict(rows=16384, warmup_rows=4096)}


def run_cpu(name, seed=5, seconds=1.5, trace=0):
    bench = spec.load_benchmark()
    cell = spec.cell(bench, name)
    return run.run_cell(bench, cell, seed, seconds, trace, "cpu",
                        t0=time.perf_counter(),
                        overrides=SIZES[cell["config"]])
