"""Time the `wkv6` kernel of this tree beside that of another tree on one
GPU, in turns, at rwkv6-3b's prefill shape; optionally print where a
block's cycles go.

    git archive <commit> | tar -x -C build/pair/A      # the other tree
    PYTHONPATH=src python3 -m repro_torch.launch.wkv6_pair \\
        --other build/pair/A [--trace]

Each tree's `csrc/wkv6.cu` is compiled by nvcc with the port's flags
into `build/pair/` and loaded with ctypes (`launch/pair.py`); both run on the same inputs
(b 8, s 2,048, 48 heads, K 64, chunk 64, f32, decays of −e^N(0, 0.5) a
token, so the exponent clip binds as on the path), first checked against
each other, then timed in the order other, this, this, other: each time
the median of CUDA-event times over 20 launches, each after 256 MB were
zeroed (`chip_smoke.py` phase 12's timing). With --trace, this tree is
also built with -DWKV6_TRACE and the cycles of each phase of block (0, 0)
are printed per warp, summed over its chunks and divided by their
number. One line a measurement; it exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.launch.pair import (ORDER, build_kernel, card, events_ms,
                                     flush_buffer)

SHAPE = (8, 2048, 48, 64)       # rwkv6-3b prefill: b, s, padded heads, K
CHUNK = 64
PHASES = {"prep": ("wait r/k/la", "a and beta", "wait kd free",
                   "scaled tiles"),
          "math": ("wait prep", "att (and wait v)", "o", "dS")}


def _launch(lib, r, k, v, la, u, out):
    b, s, H, K = r.shape
    err = lib.wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(), la.data_ptr(),
                   u.data_ptr(), out.data_ptr(), b, s, H, K, CHUNK,
                   *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                   *la.stride()[:3], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(lib.wkv6_error_string(err).decode())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other tree (holds src/repro_torch)")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wkv6_pair: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    print(card(), flush=True)
    here = Path(__file__).resolve().parents[3]
    libs = {"other": build_kernel(args.other, "wkv6", "other"),
            "this": build_kernel(here, "wkv6", "this")}

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    r, k, v = (torch.randn(SHAPE, generator=gen, device=dev) for _ in "rkv")
    la = -torch.exp(torch.randn(SHAPE, generator=gen, device=dev) * 0.5)
    u = torch.randn(SHAPE[2:], generator=gen, device=dev)
    outs = {name: torch.empty(SHAPE, device=dev) for name in libs}
    for name, lib in libs.items():
        _launch(lib, r, k, v, la, u, outs[name])
    torch.cuda.synchronize()
    diff = outs["this"] - outs["other"]
    print(f"this vs other: max_abs_diff {float(diff.abs().max()):.3e} "
          f"rel_norm_diff "
          f"{float(diff.norm() / outs['other'].norm()):.3e}", flush=True)

    flush = flush_buffer(dev)
    for name in ORDER:
        ms = events_ms(lambda: _launch(libs[name], r, k, v, la, u,
                                       outs["this"]), 20, flush)
        print(f"wkv6 {name} ms {ms:.5f}", flush=True)

    if args.trace:
        lib = build_kernel(here, "wkv6", "trace", ["-DWKV6_TRACE"])
        lib.wkv6_trace.restype = ctypes.c_int
        lib.wkv6_trace.argtypes = [ctypes.c_void_p]
        _launch(lib, r, k, v, la, u, outs["this"])
        torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * (16 * 6))()
        if lib.wkv6_trace(cycles):
            raise RuntimeError("wkv6_trace failed")
        per = np.array(cycles, dtype=np.float64).reshape(16, 6)
        per /= -(-SHAPE[1] // CHUNK)
        for w in range(16):
            group = "prep" if w < 8 else "math"
            print(f"trace warp {w} ({group}) cycles a chunk: " + ", ".join(
                f"{p} {c:.0f}" for p, c in zip(PHASES[group], per[w])),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
