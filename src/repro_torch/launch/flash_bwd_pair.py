"""Time the `flash_attention_bwd` kernels of this tree beside those of
another tree on one GPU, in turns, at tinyllama-1.1b's training shape and
at a head dim 128 shape.

    git archive <commit> | tar -x -C build/pair/A      # the other tree
    PYTHONPATH=src python3 -m repro_torch.launch.flash_bwd_pair \\
        --other build/pair/A

Each tree's `csrc/flash_attention_bwd.cu` is compiled by nvcc with the
port's flags into `build/pair/` and loaded with ctypes (`launch/pair.py`).
Both run on the same bf16 inputs (b 8, s 2,048; 32/4 heads of 64, and
32/8 heads of 128, jamba's and pixtral's heads), with o and the logsumexp
from this tree's forward kernel: first both are held to the plain version
(`flash_attention_bwd_ref`, ‖err‖/‖want‖ of dq, dk and dv), then timed in
the order other, this, this, other: each time the median of CUDA-event
times over 20 calls, each after 256 MB were zeroed (`chip_smoke.py` phase
28's timing). The scratch each tree's C entry fills is sized for either
(this tree's padded rows hold the other's). One line a measurement, the
card's name and power limit first; it exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
from repro_torch.launch.pair import (ORDER, build_kernel, card, events_ms,
                                     flush_buffer)

SHAPES = {"tinyllama-1.1b": (8, 2048, 32, 4, 64),    # b, s, nq, nkv, hd
          "hd128": (8, 2048, 32, 8, 128)}


def _launch(lib, q, k, v, o, lse, do, scratch, outs):
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
        *(g.data_ptr() for g in outs), b, s, nq, nkv, hd, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *do.stride()[:3], hd ** -0.5, 1,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(lib.flash_attention_bwd_error_string(err).decode())


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other tree (holds src/repro_torch)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_pair: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    print(card(), flush=True)
    here = Path(__file__).resolve().parents[3]
    libs = {"other": build_kernel(args.other, "flash_attention_bwd", "other"),
            "this": build_kernel(here, "flash_attention_bwd", "this")}

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = flush_buffer(dev)
    for label, (b, s, nq, nkv, hd) in SHAPES.items():
        q, k, v, do = (torch.randn((b, s, h, hd), generator=gen, device=dev)
                       .to(torch.bfloat16) for h in (nq, nkv, nkv, nq))
        lse = torch.empty((b, nq, s), dtype=torch.float32, device=dev)
        o = fk.flash_attention(q, k, v, lse=lse)
        plan = fk.flash_bwd_plan(b, s, nq, nkv, hd, q.dtype)
        scratch = torch.empty(plan["scratch"], dtype=torch.float32,
                              device=dev)
        outs = {name: [torch.empty_like(x) for x in (q, k, v)]
                for name in libs}
        for name, lib in libs.items():
            _launch(lib, q, k, v, o, lse, do, scratch, outs[name])
        want = [g.transpose(1, 2) for g in flash_attention_bwd_ref(
            *(x.transpose(1, 2) for x in (q, k, v, o)), lse,
            do.transpose(1, 2))]
        torch.cuda.synchronize()
        for name in libs:
            print(f"{label} {name} vs plain: " + " ".join(
                f"{g}_rel_norm_err {_rel(x, w):.3e}" for g, x, w in
                zip(("dq", "dk", "dv"), outs[name], want)), flush=True)
        del want
        for name in ORDER:
            ms = events_ms(lambda: _launch(libs[name], q, k, v, o, lse, do,
                                           scratch, outs["this"]), 20, flush)
            print(f"{label} b {b} s {s} heads {nq}/{nkv} hd {hd} "
                  f"flash_attention_bwd {name} ms {ms:.5f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
