"""Training launcher of the port, the counterpart of
`repro/launch/train.py` with its flags and log lines.

Wires together: the config registry, the train state on one device,
deterministic data (`TokenStream`, shard 0 of 1), async checkpointing in
the reference's format, straggler detection, and signal-based preemption
(SIGTERM → synchronous checkpoint → clean exit → relaunch resumes).

On the CPU, the reduced same-family config:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --smoke --device cpu --steps 50 --ckpt-dir /tmp/ckpt
On the GPU (the default device), the full config:
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
      --batch 8 --seq 2048 --steps 100 --ckpt-dir ckpt

Every family trains: the attention families through the flash forward
and backward kernels on the card, the ssm family through `wkv6` and its
backward. `--mesh` takes `host` (one device) until the port has a
`torch.distributed` mesh.
"""
from __future__ import annotations

import argparse
import signal
import sys

import torch

from repro_torch.obs import clock


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", default="host", choices=["host"],
                    help="one device; pod meshes need torch.distributed")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                        restore_checkpoint, save_checkpoint)
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import TokenStream
    from repro_torch.device import resolve_device
    from repro_torch.distributed import StragglerDetector
    from repro_torch.models import build
    from repro_torch.models.steps import (init_train_state, make_train_step,
                                          train_state_specs)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mdl = build(cfg)
    ds = TokenStream(vocab_size=cfg.vocab_size, batch=args.batch,
                     seq_len=args.seq, seed=0, shard=0, num_shards=1)
    step_fn = make_train_step(mdl, lr=args.lr, warmup=20,
                              total_steps=args.steps)

    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir, keep=3)
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, start = restore_checkpoint(args.ckpt_dir,
                                          train_state_specs(mdl), device=dev)
        print(f"[train] resumed at step {start}")
    else:
        state, start = init_train_state(mdl, device=dev), 0

    # preemption: checkpoint synchronously and exit 0 so the scheduler
    # relaunches and the run resumes exactly
    stop = {"flag": False}

    def _handler(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _handler)

    detector = StragglerDetector(n_workers=1)
    m = None
    t_last = clock()
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in ds.batch_at(i).items()}
        state, m = step_fn(state, batch)
        if (i + 1) % args.log_every == 0:
            m["loss"].cpu()                     # waits for the step
            dt = clock() - t_last
            t_last = clock()
            tput = args.batch * args.seq * args.log_every / dt
            print(f"[train] step {i+1} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} {tput:.0f} tok/s",
                  flush=True)
            detector.observe({0: dt / args.log_every})
        if ckpt and (i + 1) % args.ckpt_every == 0:
            ckpt.save(state, i + 1)
        if stop["flag"]:
            print("[train] preemption signal: checkpointing + exiting",
                  flush=True)
            if args.ckpt_dir:
                if ckpt:
                    ckpt.wait()
                    ckpt.close()
                    ckpt = None
                save_checkpoint(args.ckpt_dir, state, i + 1)
            sys.exit(0)
    if ckpt:
        ckpt.save(state, args.steps)
        ckpt.wait()
        ckpt.close()
    if m is not None:
        print(f"[train] done at step {args.steps}, "
              f"final loss {float(m['loss']):.4f}")
    else:
        print(f"[train] nothing to do (already at step {start})")


if __name__ == "__main__":
    main()
