"""Time the `wkv6_bwd` kernels of this tree beside those of another tree
on one GPU, in turns, at rwkv6-3b's training shape; optionally print where
a block's cycles go and each kernel's time.

    git archive <commit> | tar -x -C build/pair/A      # the other tree
    PYTHONPATH=src python3 -m repro_torch.launch.wkv6_bwd_pair \\
        --other build/pair/A [--trace]

Each tree's `csrc/wkv6_bwd.cu` is compiled by nvcc with the port's flags
into `build/pair/` and loaded with ctypes (`launch/pair.py`). Both run on
the same inputs (b 8, s 2,048, 48 heads of 64, chunk 64, f32, decays of
−e^N(0, 0.5) a token, so the exponent clip binds as on the path): first
each is held to the plain version (`wkv6_chunked_bwd_ref`: the largest
|err| beside 5e-4 + 5e-4·|want| and ‖err‖/‖want‖ of dr, dk, dv, dla and
du), then timed in the order other, this, this, other: each time the
median of CUDA-event times over 10 calls, each after 256 MB were zeroed
(`chip_smoke.py` phase 31's timing). With --trace, this tree is also
built with -DWKV6_BWD_TRACE: one call prints the device time of its three
kernels (CUDA events the C entry records between them) and the cycles of
each phase of block (0, 0) per warp, summed over its chunks and divided
by their number. One line a measurement, the card's name and power limit
first; it exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.wkv6.ref import wkv6_chunked_bwd_ref
from repro_torch.launch.pair import (ORDER, build_kernel, card, events_ms,
                                     flush_buffer)

SHAPE = (8, 2048, 48, 64)       # rwkv6-3b training: b, s, padded heads, K
CHUNK = 64
TOL = 5e-4                      # chip_smoke.py's WKV_BWD_TOL
NAMES = ("dr", "dk", "dv", "dla", "du")
WARPS, PHASES = 8, 8
TRACED = {"state pass": ("wait k/v/la", "scan, k_dec", "dS product",
                         "state store", "", "", "", ""),
          "reverse pass": ("wait loads", "(1) scan, beta, dbeta",
                           "(2) factors", "(3) att, datt, do S^T",
                           "(4) datt k_f, dr", "(5) v dS^T, datt^T r_f, dk",
                           "(6) dv, r_in^T do", "(7) dS, dla")}


def run(lib, r, k, v, la, u, do, chunk=CHUNK):
    """One call of a loaded library's C entry `wkv6_bwd` on CUDA tensors
    laid out as `kernels.wkv6.kernel.wkv6_bwd` takes them; returns (dr,
    dk, dv, dla, du) without synchronising."""
    b, s, H, K = r.shape
    dev = r.device
    grads = [torch.empty((b, s, H, K), device=dev) for _ in range(4)]
    du = torch.empty((H, K), device=dev)
    states = torch.empty((b, H, -(-s // chunk), K, K), device=dev)
    part = torch.empty((b, H, K), device=dev)
    err = lib.wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), la.data_ptr(),
        do.data_ptr(), u.data_ptr(), states.data_ptr(), part.data_ptr(),
        *(g.data_ptr() for g in grads), du.data_ptr(), b, s, H, K, chunk,
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *la.stride()[:3],
        *do.stride()[:3], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(lib.wkv6_bwd_error_string(err).decode())
    return (*grads, du)


def trace(lib, xs):
    """One call of a -DWKV6_BWD_TRACE build: (ms of the state pass, the
    reverse pass and du; cycles a chunk (2, warps, phases), the state pass
    first)."""
    lib.wkv6_bwd_trace.restype = ctypes.c_int
    lib.wkv6_bwd_trace.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    run(lib, *xs)
    cycles = (ctypes.c_ulonglong * (2 * WARPS * PHASES))()
    ms = (ctypes.c_float * 3)()
    if lib.wkv6_bwd_trace(cycles, ms):
        raise RuntimeError("wkv6_bwd_trace failed")
    per = np.array(cycles, dtype=np.float64).reshape(2, WARPS, PHASES)
    return list(ms), per / -(-xs[0].shape[1] // CHUNK)


def inputs(dev, shape=SHAPE, seed=0):
    """r, k, v, la (−e^N(0, 0.5)), u (H, K) and do on `dev`."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn(shape, generator=gen, device=dev) for _ in "rkv")
    la = -torch.exp(torch.randn(shape, generator=gen, device=dev) * 0.5)
    u = torch.randn(shape[2:], generator=gen, device=dev)
    do = torch.randn(shape, generator=gen, device=dev)
    return r, k, v, la, u, do


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other tree (holds src/repro_torch)")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wkv6_bwd_pair: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    print(card(), flush=True)
    here = Path(__file__).resolve().parents[3]
    libs = {"other": build_kernel(args.other, "wkv6_bwd", "other"),
            "this": build_kernel(here, "wkv6_bwd", "this")}
    dev = torch.device("cuda", 0)
    xs = inputs(dev)
    want = wkv6_chunked_bwd_ref(*xs, CHUNK)
    for name, lib in libs.items():
        got = run(lib, *xs)
        torch.cuda.synchronize()
        fields = []
        for gname, g, w in zip(NAMES, got, want):
            err = (g - w).abs()
            bad = int((err > TOL + TOL * w.abs()).sum())
            rel = float((g - w).norm() / w.norm())
            fields.append(f"{gname} max_abs_err {float(err.max()):.3e} "
                          f"violations {bad} rel_norm_err {rel:.3e}")
        print(f"{name} vs plain: " + "; ".join(fields), flush=True)
        del got
    del want

    flush = flush_buffer(dev)
    for name in ORDER:
        ms = events_ms(lambda: run(libs[name], *xs), 10, flush)
        print(f"wkv6_bwd {name} ms {ms:.5f}", flush=True)

    if args.trace:
        lib = build_kernel(here, "wkv6_bwd", "trace", ["-DWKV6_BWD_TRACE"])
        ms, per = trace(lib, xs)
        print("trace kernels ms: " + ", ".join(
            f"{n} {t:.5f}" for n, t in zip(("state pass", "reverse pass",
                                            "du"), ms)), flush=True)
        for kernel, (label, phases) in enumerate(TRACED.items()):
            for w in range(WARPS):
                print(f"trace {label} warp {w} cycles a chunk: " + ", ".join(
                    f"{p} {c:.0f}" for p, c in zip(phases, per[kernel, w])
                    if p), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
