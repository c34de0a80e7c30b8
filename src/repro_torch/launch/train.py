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
backward.

`--mesh host` (the default) trains on one device. `--mesh pod` and
`--mesh multipod` start a `torch.distributed` process group from
torchrun's environment (or `--init-method`) and build the production
mesh, (16, 16) or (2, 16, 16): a world of another size raises and names
the size it needs. Every rank reads the same global batch and the step
takes its rows (data-parallel over "pod" and "data"; "model" replicates
the step). Rank 0 writes the checkpoints and prints the log lines.
  torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
      --arch tinyllama-1.1b --mesh pod --steps 100 --ckpt-dir ckpt
"""
from __future__ import annotations

import argparse
import signal
import sys

import torch
import torch.distributed as dist

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
    ap.add_argument("--mesh", default="host",
                    choices=["host", "pod", "multipod"],
                    help="host: one device; pod (16 x 16) and multipod "
                         "(2 x 16 x 16): a torch.distributed world")
    ap.add_argument("--init-method", default=None,
                    help="the process group's rendezvous (default: "
                         "torchrun's environment)")
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

    if args.mesh == "host":
        dev, mesh, rank, world = resolve_device(args.device), None, 0, 1
    else:
        from repro_torch.launch.mesh import (init_process_group,
                                             make_production_mesh)
        dev = init_process_group(args.device, init_method=args.init_method)
        mesh = make_production_mesh(multi_pod=args.mesh == "multipod")
        rank, world = dist.get_rank(), dist.get_world_size()
    log = print if rank == 0 else (lambda *a, **k: None)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mdl = build(cfg)
    ds = TokenStream(vocab_size=cfg.vocab_size, batch=args.batch,
                     seq_len=args.seq, seed=0, shard=0, num_shards=1)
    step_fn = make_train_step(mdl, lr=args.lr, warmup=20,
                              total_steps=args.steps, mesh=mesh)

    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir, keep=3)
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, start = restore_checkpoint(args.ckpt_dir,
                                          train_state_specs(mdl, mesh),
                                          device=dev)
        log(f"[train] resumed at step {start}")
    else:
        state, start = init_train_state(mdl, device=dev), 0

    # preemption: checkpoint synchronously and exit 0 so the scheduler
    # relaunches and the run resumes exactly
    stop = {"flag": False}

    def _handler(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _handler)

    detector = StragglerDetector(n_workers=world)
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
            log(f"[train] step {i+1} loss {float(m['loss']):.4f} "
                f"gnorm {float(m['grad_norm']):.3f} {tput:.0f} tok/s",
                flush=True)
            detector.observe({rank: dt / args.log_every})
        if ckpt and (i + 1) % args.ckpt_every == 0:
            ckpt.save(state, i + 1)
        if mesh is not None:
            # a signal may reach the ranks at different steps: stop all
            # together when any has it
            flag = torch.tensor([int(stop["flag"])], device=dev)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            stop["flag"] = bool(flag.item())
        if stop["flag"]:
            log("[train] preemption signal: checkpointing + exiting",
                flush=True)
            if args.ckpt_dir:
                if ckpt:
                    ckpt.wait()
                    ckpt.close()
                    ckpt = None
                save_checkpoint(args.ckpt_dir, state, i + 1)
            _end(mesh)
            sys.exit(0)
    if ckpt:
        ckpt.save(state, args.steps)
        ckpt.wait()
        ckpt.close()
    if m is not None:
        log(f"[train] done at step {args.steps}, "
            f"final loss {float(m['loss']):.4f}")
    else:
        log(f"[train] nothing to do (already at step {start})")
    _end(mesh)


def _end(mesh):
    """Leave the process group (pod meshes)."""
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
