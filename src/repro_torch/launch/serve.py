"""Serving launcher of the port, the counterpart of `repro/launch/serve.py`:
the classification-view service over an LM-encoded corpus (`--mode view`,
the default; `launch/view_driver.py`), the SQL front end over the same
engines (`--mode sql`) and LM decode serving (`--mode decode`).

  PYTHONPATH=src python -m repro_torch.launch.serve --mode view \
      --requests 2000 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --mode sql   # REPL
  PYTHONPATH=src python -m repro_torch.launch.serve --mode sql \
      --script demo.sql
  PYTHONPATH=src python -m repro_torch.launch.serve --mode sql \
      --device cpu --execute "SHOW TABLES"
  PYTHONPATH=src python -m repro_torch.launch.serve --mode sql \
      --serve 127.0.0.1:5433 --script schema.sql   # concurrent SQL server

  PYTHONPATH=src python -m repro_torch.launch.serve --mode decode \
      --arch tinyllama-1.1b --steps 64 --batch 4 --cache-len 256
  PYTHONPATH=src python -m repro_torch.launch.serve --mode decode \
      --arch rwkv6-3b --steps 64 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --mode decode --smoke \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --mode decode --smoke \
      --device cpu --arch rwkv6-3b
  PYTHONPATH=src python -m repro_torch.launch.serve --mode decode --smoke \
      --device cpu --arch jamba-v0.1-52b
  PYTHONPATH=src python -m repro_torch.launch.serve --mode decode --smoke \
      --device cpu --arch whisper-tiny     # or pixtral-12b, qwen1.5-32b

The reference serves the smoke twin of the architecture; the port serves
the full configuration (`get_config`) unless `--smoke` is passed, on the
GPU unless `--device cpu` is. The dense, vlm and moe families
(tinyllama-1.1b, pixtral-12b, llama4-scout-17b-a16e, ...; qwen1.5-32b in
its f8 e4m3fn cache) decode over a KV cache of `--cache-len` positions,
the hybrid family (jamba-v0.1-52b) over one at its attention layers
beside a fixed-size mamba state at the others; the ssm family (rwkv6-3b)
keeps a fixed-size RWKV state per layer, so `--cache-len` neither sizes
it nor bounds `--steps`. The audio family (whisper-tiny) decodes over its
self-attention cache against the zero cross cache that `init_cache`
gives, as the reference's `serve_decode` does: serving runs no encoder
step (a caller fills the cross k/v from `ModelDef.encode` and
`layers.encode_kv`). `--mode view` serves
`--requests` requests through `view_driver.serve_view` (4,000 documents
of 32 tokens, the reference's defaults). `--mode sql` runs the
relational front end (`repro_torch.rdbms`) with every view's engine on
the device: in server mode (`--serve HOST:PORT`) an optional
--script/--execute runs first against the shared executor (schema
bootstrap), then the asyncio server accepts concurrent wire-protocol
sessions (`repro_torch.rdbms.client` speaks it, as does the reference's
client) with the freshness scheduler running, until interrupted.
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
    token and an empty cache of `cache_len` positions (with a zero mamba
    state at the hybrid family's mamba layers; a zero RWKV state for the
    ssm family, which `cache_len` does not size; a zero cross cache for
    the audio family), on `device`
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


def serve_sql(script: str = None, execute: str = None, serve: str = None,
              slow_ms: float = None, log_statements: bool = False,
              device=None):
    """The SQL front end over one executor whose catalog builds every
    view on `device` (None: the GPU; raises without one unless "cpu" is
    asked): `script` (a .sql file) or `execute` (;-separated statements),
    else the REPL; with `serve` ("HOST:PORT") the wire server after them.
    Returns the executor (None after server mode)."""
    from repro_torch.rdbms.executor import Executor
    from repro_torch.rdbms.repl import repl, run_script
    ex = Executor(slow_ms=slow_ms, device=device)
    if slow_ms is not None or log_statements:
        import logging
        logging.basicConfig(level=logging.INFO)  # slow/access logs visible
    if serve:
        import asyncio
        from repro_torch.rdbms.server import SqlServer
        host, _, port = serve.rpartition(":")
        if not host or not port.isdigit():
            raise SystemExit(f"--serve wants HOST:PORT, got {serve!r}")
        # schema bootstrap runs before the first connection is accepted
        if script:
            with open(script) as fh:
                run_script(fh.read(), ex)
        elif execute:
            run_script(execute, ex)
        # the freshness scheduler runs for the server's whole lifetime:
        # views with a target_lag are refreshed in the background while
        # sessions are served (idle ticks are one catalog scan)
        from repro_torch.scheduler import FreshnessScheduler
        refresher = FreshnessScheduler(ex).start()

        async def _serve():
            server = SqlServer(ex, host=host, port=int(port),
                               log_statements=log_statements)
            await server.start()
            print(f"[serve] sql server on {server.host}:{server.port} "
                  f"(length-prefixed JSON; freshness scheduler on; "
                  f"Ctrl-C to stop)")
            try:
                await server.serve_forever()
            finally:
                refresher.stop()

        try:
            asyncio.run(_serve())
        except KeyboardInterrupt:
            print("[serve] sql server stopped")
        return None
    if script:
        with open(script) as fh:
            run_script(fh.read(), ex)
    elif execute:
        run_script(execute, ex)
    else:
        repl(ex)
    return ex


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="view",
                    choices=["view", "sql", "decode"])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced smoke twin of --arch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--script", default=None,
                    help="sql mode: run this .sql file instead of the REPL")
    ap.add_argument("--execute", default=None,
                    help="sql mode: run these ;-separated statements")
    ap.add_argument("--serve", default=None, metavar="HOST:PORT",
                    help="sql mode: run the concurrent wire-protocol "
                         "server instead of the REPL (--script/--execute "
                         "bootstrap the schema first)")
    ap.add_argument("--slow-ms", type=float, default=None,
                    help="sql mode: log the span tree of any statement "
                         "slower than this many milliseconds")
    ap.add_argument("--log-statements", action="store_true",
                    help="sql mode: access log — one structured line per "
                         "served statement")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    if args.mode == "sql":
        return serve_sql(args.script, args.execute, args.serve,
                         slow_ms=args.slow_ms,
                         log_statements=args.log_statements,
                         device=args.device)
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
