"""Run the full dry-run sweep: every (arch × shape) × both meshes + the
hazy-view cells, the counterpart of `repro/launch/sweep.py` (the same
cells in the same order). One subprocess per cell of `python -m
repro_torch.launch.dryrun` (on meta tensors: no GPU; a crash in one cell
does not stop the sweep). Resumable: cells with an existing JSON are
skipped; each run is a line of `sweep_log.jsonl` (a failing cell with the
tail of its errors).

  PYTHONPATH=src python -m repro_torch.launch.sweep [--out results/dryrun]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from repro_torch.obs import clock


def jobs():
    from repro_torch.configs.registry import cells
    out = []
    # risky/expensive families first so failures surface early
    order = {"jamba-v0.1-52b": 0, "rwkv6-3b": 1, "whisper-tiny": 2,
             "dbrx-132b": 3, "pixtral-12b": 4}
    cs = sorted(cells(), key=lambda c: order.get(c[0], 9))
    for multipod in (False, True):
        for arch, shape in cs:
            out.append((arch, shape, multipod))
        out.append(("hazy-view", "view_64m", multipod))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    log_path = os.path.join(args.out, "sweep_log.jsonl")
    todo = jobs()
    t0 = clock()
    n_ok = n_fail = n_skip = 0
    for i, (arch, shape, multipod) in enumerate(todo):
        mesh = "pod2x16x16" if multipod else "pod16x16"
        out_json = os.path.join(args.out, f"{arch}__{shape}__{mesh}.json")
        if os.path.exists(out_json):
            n_skip += 1
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--out", args.out]
        if multipod:
            cmd.append("--multipod")
        t1 = clock()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=args.timeout)
            ok = proc.returncode == 0
        except subprocess.TimeoutExpired:
            ok = False
            proc = None
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "ok": ok,
               "seconds": round(clock() - t1, 1)}
        if not ok:
            rec["tail"] = (proc.stderr[-2000:] if proc else "TIMEOUT")
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        n_ok += ok
        n_fail += (not ok)
        print(f"[{i+1}/{len(todo)}] {arch} {shape} {mesh}: "
              f"{'ok' if ok else 'FAIL'} ({rec['seconds']}s)", flush=True)
    print(f"done: {n_ok} ok, {n_fail} fail, {n_skip} skipped, "
          f"{(clock()-t0)/60:.1f} min")


if __name__ == "__main__":
    main()
