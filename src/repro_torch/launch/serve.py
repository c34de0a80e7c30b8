"""Serving launcher of the port, the counterpart of `repro/launch/serve.py`:
LM decode serving (`--mode decode`) and the classification-view service
over an LM-encoded corpus (`--mode view`, `launch/view_driver.py`).

  PYTHONPATH=src python -m repro_torch.launch.serve --mode view \
      --requests 2000 [--device cpu]

  PYTHONPATH=src python -m repro_torch.launch.serve --mode decode \
      --arch tinyllama-1.1b --steps 64 --batch 4 --cache-len 256
  PYTHONPATH=src python -m repro_torch.launch.serve --mode decode \
      --arch rwkv6-3b --steps 64 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --mode decode --smoke \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --mode decode --smoke \
      --device cpu --arch rwkv6-3b

The reference serves the smoke twin of the architecture; the port serves
the full configuration (`get_config`) unless `--smoke` is passed, on the
GPU unless `--device cpu` is. The dense family (tinyllama-1.1b, ...)
decodes over a KV cache of `--cache-len` positions; the ssm family
(rwkv6-3b) keeps a fixed-size RWKV state per layer, so `--cache-len`
neither sizes it nor bounds `--steps`. `--mode view` serves
`--requests` requests through `view_driver.serve_view` (4,000 documents
of 32 tokens, the reference's defaults). `--mode sql` raises until
`rdbms/` is ported (ROADMAP.md Queue 1 item 7).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import torch

from repro_torch.obs import clock


@dataclasses.dataclass
class DecodeRun:
    tokens: torch.Tensor             # (batch, steps) int32, on the device
    seconds: float                   # host clock, first launch to last sync
    step_ms: Optional[List[float]]   # device time per step; None on the CPU


def decode_loop(step, params, cache, token, start: int, steps: int,
                marks=None):
    """Greedy decode of `steps` tokens from position `start`, each step's
    token fed to the next. `marks` (CUDA events, steps + 1 of them) are
    recorded before the first step and after each. Returns
    (tokens (b, steps) int32, cache)."""
    out = []
    if marks:
        marks[0].record()
    for j in range(steps):
        token, cache = step(params, cache, token, start + j)
        out.append(token)
        if marks:
            marks[j + 1].record()
    return torch.cat(out, 1), cache


def serve_decode(arch: str, steps: int, batch: int, cache_len: int, *,
                 smoke: bool = False, seed: int = 0, device=None,
                 params=None) -> DecodeRun:
    """Greedy decode of `steps` tokens for `batch` sequences from a zero
    token and an empty cache of `cache_len` positions (a zero RWKV state
    for the ssm family, which `cache_len` does not size), on `device`
    (None: the GPU; raises without one unless "cpu" is asked). Serves
    `params` where given, else weights drawn from `seed`. Prints the
    reference's line (tok/s, ms/step)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build
    from repro_torch.models.steps import (init_cache, init_serving_params,
                                          make_decode_step)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    if cfg.family != "ssm" and steps > cache_len:
        raise ValueError(f"{steps} steps overrun a cache of {cache_len}")
    dev = resolve_device(device)
    mdl = build(cfg)
    if params is None:
        params = init_serving_params(mdl, seed, dev)
    cache = init_cache(mdl, batch, cache_len, device=dev)
    dec = make_decode_step(mdl)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    cuda = dev.type == "cuda"
    marks = ([torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
             if cuda else None)
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = clock()
    tokens, cache = decode_loop(dec, params, cache, tok, 0, steps, marks)
    if cuda:
        torch.cuda.synchronize(dev)
    dt = clock() - t0
    step_ms = ([a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
               if cuda else None)
    print(f"[serve] decode: {steps} steps x batch {batch} -> "
          f"{steps * batch / dt:.0f} tok/s ({dt / steps * 1e3:.1f} ms/step)")
    return DecodeRun(tokens, dt, step_ms)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="decode",
                    choices=["view", "sql", "decode"])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced smoke twin of --arch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    if args.mode == "sql":
        raise NotImplementedError("--mode sql is not ported yet: ROADMAP.md "
                                  "Queue 1 item 7 (rdbms/)")
    if args.mode == "view":
        from repro_torch.launch.view_driver import main as view_main
        argv = ["--requests", str(args.requests)]
        if args.device is not None:
            argv += ["--device", args.device]
        return view_main(argv)
    return serve_decode(args.arch, args.steps, args.batch, args.cache_len,
                        smoke=args.smoke, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
