"""Time `eps_affine` under other tile plans than its default, and both
single-view kernels under their default plans, on one GPU, beside
`torch.mv` and an empty operation; with --multiview, time
`multiview_band_reclassify` under other plans instead.

    PYTHONPATH=src python3 -m repro_torch.launch.plan_sweep [--multiview]

`eps_affine` takes its layout from a plan computed in Python
(`tile_plan`), so this calls its C entry with other plans and needs no
rebuild. Each time is the median of CUDA-event times over 40 launches,
each after 256 MB were zeroed (as `chip_smoke.py` phase 6 times them:
the L2 cache cold and full of dirty lines), and, for the default plans,
also after 256 MB were read (cold, clean lines). The empty operation (a
one-element add) is the floor of that timing. The multi-view kernel's
plan (`multiview_plan`) is passed to its C entry too: --multiview times it
at Forest's width (k 7, cap 291,008) at `launch/mv_band_pair.py`'s
geometries A (1% a view) and B (10%) under 4 to 32 lanes a row and one to
three blocks an SM, and under its own plan with every window empty (the
kernel's prologue alone). One line a measurement; it exits non-zero
without a GPU.
"""
from __future__ import annotations

import argparse
import sys
from math import gcd

import numpy as np
import torch

WIDTHS = {"forest": (582_000, 54, torch.float32),
          "dblife": (124_000, 1024, torch.float32),
          "dblife-bf16": (124_000, 1024, torch.bfloat16),
          "citeseer": (120_000, 4096, torch.float32)}
# (tile KB, stages, blocks an SM) for eps_affine; the default is (32, 2, 2)
EPS_PLANS = [(16, 2, 3), (16, 3, 2), (16, 4, 2), (16, 6, 2), (24, 3, 2),
             (32, 2, 2), (32, 3, 2), (32, 2, 3), (48, 2, 2), (64, 2, 1)]


MV_LANES = (4, 8, 16, 32)       # lanes a row at Forest's 8-byte chunks
MV_BLOCKS_PER_SM = (1, 2, 3)


def _multiview(ms, dev):
    from repro_torch.kernels.band_reclassify.kernel import SMS, multiview_plan
    from repro_torch.kernels.build import load
    from repro_torch.launch.mv_band_pair import (BLOCK_N, CAP, FOREST,
                                                 spread_windows)
    n, d, k = FOREST
    gen = torch.Generator(device=dev).manual_seed(0)
    F = torch.randn(n, d, generator=gen, device=dev)
    W = torch.randn(k, d, generator=gen, device=dev) / d ** 0.5
    b = torch.randn(k, generator=gen, device=dev) * 0.1
    labels = torch.ones((k, n), dtype=torch.int8, device=dev)
    lib = load("band_reclassify")
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = multiview_plan(k, d, CAP, F.data_ptr() % 16)
    geometries = {"A": spread_windows(n, k, CAP, BLOCK_N, 0.01),
                  "B": spread_windows(n, k, CAP, BLOCK_N, 0.1),
                  "empty": ([0] * k, [0] * k)}
    for geo, (sb, wd) in geometries.items():
        sbt = torch.tensor(sb, dtype=torch.int32, device=dev)
        wdt = torch.tensor(wd, dtype=torch.int32, device=dev)
        for lanes in MV_LANES:
            for per_sm in MV_BLOCKS_PER_SM:
                grid = per_sm * SMS
                mine = (lanes, grid) == (plan.lanes, plan.grid)
                if geo == "empty" and not mine:
                    continue

                def run(lanes=lanes, grid=grid):
                    err = lib.mv_band_reclassify(
                        F.data_ptr(), labels.data_ptr(), W.data_ptr(),
                        b.data_ptr(), sbt.data_ptr(), wdt.data_ptr(), n, d,
                        k, BLOCK_N, plan.chunk_bytes, lanes, grid,
                        plan.smem_bytes, stream)
                    if err:
                        raise RuntimeError(f"multi-view plan refused ({err})")
                print("multiview", geo, f"lanes={lanes} blocks_per_sm="
                      f"{per_sm}" + (" (multiview_plan)" if mine else ""),
                      ms(run), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multiview", action="store_true",
                    help="sweep the multi-view kernel's plans instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("plan_sweep: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from repro_torch.kernels.band_reclassify import kernel as band
    from repro_torch.kernels.build import load
    from repro_torch.kernels.eps_affine import kernel as eps
    dev = torch.device("cuda", 0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def ms(fn, mode="write", reps=40):
        fn()
        torch.cuda.synchronize()
        marks = []
        for _ in range(reps):
            flush.zero_() if mode == "write" else flush.sum()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            marks.append((s, e))
        torch.cuda.synchronize()
        return f"{np.median([s.elapsed_time(e) for s, e in marks]):.5f}"

    from repro_torch.launch.pair import card
    print(card(), flush=True)
    tiny = torch.zeros(1, device=dev)
    for mode in ("write", "read"):
        print("floor", mode, ms(lambda: tiny.add_(1), mode), flush=True)
    if args.multiview:
        _multiview(ms, dev)
        return 0
    elib = load("eps_affine")
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = eps._count_scratch(dev, stream).data_ptr()
    gen = torch.Generator(device=dev).manual_seed(2)
    for name, (n, d, dt) in WIDTHS.items():
        F = torch.randn(n, d, generator=gen, device=dev).to(dt)
        size = F.element_size()
        w = torch.randn(d, generator=gen, device=dev) / d ** 0.5
        b = torch.zeros((), device=dev)
        out = (torch.empty(n, device=dev),
               torch.empty(n, dtype=torch.int8, device=dev),
               torch.empty((), dtype=torch.int32, device=dev))
        base = eps.tile_plan(n, d, size)
        row = d * size
        for kb, stages, per_sm in EPS_PLANS:
            r0 = 16 // gcd(row, 16)
            R = r0 * max(1, kb * 1024 // (r0 * row))
            if per_sm * (stages * R * row + 4 * d + 1300) > 233_472:
                continue                  # does not fit the SM

            def run(R=R, stages=stages, grid=min(per_sm * 132, n // R)):
                err = elib.eps_affine(
                    F.data_ptr(), w.data_ptr(), b.data_ptr(),
                    *(t.data_ptr() for t in out), scratch + 4, scratch, n, d,
                    int(size == 2), R, stages, grid, base.lanes, stream)
                if err:
                    raise RuntimeError(f"eps_affine plan refused ({err})")
            print("eps", name, f"tile_kb={kb} stages={stages} "
                  f"blocks_per_sm={per_sm}", ms(run), flush=True)
        w_lib = w.to(dt)
        for mode in ("write", "read"):
            print("eps", name, "default", mode,
                  ms(lambda: eps.eps_affine(F, w, b), mode), "torch.mv",
                  ms(lambda: torch.mv(F, w_lib), mode), flush=True)
        width, lo = n // 100, n // 3
        labels = torch.ones(n, dtype=torch.int8, device=dev)
        for mode in ("write", "read"):
            kern = ms(lambda: band.band_reclassify(F, labels, w, b, lo,
                                                   width), mode)
            lib = ms(lambda: torch.mv(F[lo:lo + width], w_lib), mode)
            print("band", name, "default", mode, kern, "torch.mv", lib,
                  flush=True)
        del F
    return 0


if __name__ == "__main__":
    sys.exit(main())
