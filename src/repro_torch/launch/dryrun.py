"""Dry run of one (arch × shape × mesh) cell on meta tensors: one rank's
program of the reference's production cell, counted, on a host without a
GPU; the counterpart of `repro/launch/dryrun.py` with its names, flags
and JSON keys.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
      --shape train_4k [--multipod] [--rank R] [--out results/dryrun]

The reference lowers and compiles each cell with XLA on 256 or 512 fake
devices and reads XLA's cost and memory analyses. The port runs eagerly,
so here the step itself runs once on `device="meta"` tensors (shapes and
dtypes, no storage: nothing is allocated) on an abstract production mesh
(`launch.mesh.Mesh.abstract`, (16, 16) or (2, 16, 16)) at one rank, the
rank's blocks of the inputs laid out by the reference's rules. Every
kernel wrapper, given meta tensors, launches nothing and records its
call's cost (`kernels/dry.py`); every collective records its calls and
bytes and calls no `dist` function. The record:

  * `flops_per_device`: the products' FLOPs as
    `torch.utils.flop_counter.FlopCounterMode` counts them, plus the
    kernels' own (`kernel.<name>_cost`); elementwise work is not counted;
  * `bytes_per_device`: the inputs plus outputs of every aten op
    dispatched but views and empty allocations, plus the kernels' bytes:
    the eager port's unfused traffic, an upper bound of what a fused
    program would move;
  * `collectives`: `hlo_stats.collective_bytes` of the mesh's records;
  * `memory`: `argument_bytes` the rank's abstract inputs;
    `temp_bytes` the peak of the bytes allocated during the step and
    alive at once, tracked through storage lifetimes; `alias_bytes` the
    inputs the step writes in place (the train state, the cache: the
    reference's donated arguments) and `output_bytes` the step's outputs,
    those included;
  * `kernels`: each kernel's calls, FLOPs and bytes.

`lower_s` is the seconds to build the inputs and run the step on meta
tensors (the trace); `compile_s` is 0.0: nothing is compiled. A train
cell runs the port's `make_train_step` at the config's `microbatches`
(its batch the global one, of which the step takes the rank's rows, as
on a live mesh; `argument_bytes` counts those rows); a decode cell steps
at index seq_len − 1, where every cache row is attended (the port reads
rows up to the index only; the audio family's cross cache is read
whole). `--arch hazy-view` counts the paper's three maintenance
steps (naive, banded, reorganize) over a pod-scale entity table; the
banded step at the reference's static window (`core.sharded.
hazy_update_window`), since the port's own reads the band's edges on the
host, which a meta tensor cannot give.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import weakref
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import dry
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs import clock

HAZY_SHAPES = {
    # (entities, feature_dim): a pod-scale corpus — 64Mi rows x 4096 dims
    # (bf16 features = 512 GiB, 2 GiB a rank on the single-pod mesh).
    "view_64m": (1 << 26, 4096),
    # smaller variant for quick iteration
    "view_8m": (1 << 23, 4096),
}

# ops that allocate without touching memory
_FREE = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
         torch.ops.aten.empty_strided.default}


def _mesh(multi_pod: bool, rank: int = 0):
    return mesh_lib.make_production_mesh(multi_pod=multi_pod, abstract=True,
                                         rank=rank)


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storages(tree):
    """{id: nbytes} of the distinct storages under `tree`."""
    return {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in _tensors(tree)}


@dataclasses.dataclass
class Lowered:
    """A step ready to run once on meta tensors: `run()` calls it on
    `inputs`; `arguments` are the rank's abstract inputs (what
    `argument_bytes` counts) and `donated` the inputs it writes in place;
    `grad` says the step differentiates (train)."""
    run: Callable[[], Any]
    arguments: Any
    donated: Any = None
    grad: bool = False


class _Count(TorchDispatchMode):
    """Bytes of every op dispatched (inputs plus outputs, views and empty
    allocations aside) and the peak of the bytes allocated in the step
    and alive at once (storages of the op outputs, by their lifetimes;
    the arguments' own storages excluded)."""

    def __init__(self, argument_storages):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._known = set(argument_storages)

    def _release(self, key, nbytes):
        self._known.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func in _FREE:
            return out
        self.ops += 1
        for t in _tensors((args, kwargs)) + _tensors(out):
            self.bytes += t.numel() * t.element_size()
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._known:
                continue
            self._known.add(key)
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._release, key, st.nbytes())
        return out


def lower_lm_cell(arch: str, shape, mesh, donate: bool = True, cfg=None):
    """({step_name: (Lowered, seconds to build)}, cfg, shape) of an LM
    cell; `shape` a name of `SHAPES` or a `ShapeConfig`; `mesh` an
    abstract mesh (or None: one process); `cfg` in place of the arch's
    registered config (a twin)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import build
    from repro_torch.models.steps import (abstract_tree, batch_specs,
                                          decode_input_specs, local,
                                          long_context, make_decode_step,
                                          make_prefill_step, make_train_step,
                                          train_state_specs)
    from repro_torch.optim import tree_leaves as state_leaves
    cfg = get_config(arch) if cfg is None else cfg
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mdl = build(cfg)
    t0 = clock()
    if shape.kind == "train":
        state = local(train_state_specs(mdl, mesh))
        for p in state_leaves(state["params"]):
            p.requires_grad_(True)
        rows = local(batch_specs(cfg, shape, mesh))
        batch = local(batch_specs(cfg, shape))     # the step takes its rows
        step = make_train_step(mdl, mesh=mesh)
        low = Lowered(lambda: step(state, batch), (state, rows),
                      state if donate else None, grad=True)
        name = "train_step"
    elif shape.kind == "prefill":
        params = local(abstract_tree(mdl.param_tree, mesh))
        batch = local(batch_specs(cfg, shape, mesh))
        step = make_prefill_step(mdl, mesh)
        low = Lowered(lambda: step(params, batch), (params, batch))
        name = "prefill_step"
    else:
        params = local(abstract_tree(mdl.param_tree, mesh))
        cache, token, index = local(decode_input_specs(mdl, shape, mesh))
        step = make_decode_step(mdl, mesh, batch=shape.global_batch,
                                cache_len=shape.seq_len,
                                long_ctx=long_context(shape))
        low = Lowered(lambda: step(params, cache, token, shape.seq_len - 1),
                      (params, cache, token, index),
                      cache if donate else None)
        name = "decode_step"
    return {name: (low, clock() - t0)}, cfg, shape


def lower_hazy_cell(shape_name: str, mesh):
    """({step_name: (Lowered, seconds)}, n, d) of the hazy-view cell: the
    naive, banded and reorganize steps over the rank's block of the
    reference's dry-run state, w (d,) f32 over "model"."""
    from repro_torch.core.sharded import (hazy_update_window, naive_update,
                                          reorganize, state_specs,
                                          window_cap)
    from repro_torch.models.params import Sharded, local_shape
    from repro_torch.models.steps import local
    n, d = HAZY_SHAPES[shape_name]
    out = {}
    spec = ("model" if "model" in mesh.axis_names else None,)
    for name, make in (
            ("hazy_naive_step", lambda st, w, b: naive_update(st, w, b, mesh)),
            ("hazy_banded_step", lambda st, w, b: hazy_update_window(
                st, w, b, cap=window_cap(n, mesh), mesh=mesh)),
            ("hazy_reorg_step", lambda st, w, b: reorganize(st, w, b, mesh))):
        t0 = clock()
        st = local(state_specs(n, d, mesh))
        w = local(Sharded(spec, (d,), torch.float32, torch.empty(
            local_shape((d,), spec, mesh), dtype=torch.float32,
            device="meta"), mesh))
        b = torch.empty((), dtype=torch.float32, device="meta")
        out[name] = (Lowered(lambda st=st, w=w, b=b, make=make:
                             make(st, w, b), (st, w, b)), clock() - t0)
    return out, n, d


def measure(low: Lowered) -> Dict[str, Any]:
    """Run the step once under the counters: FLOPs, bytes, collectives,
    memory, kernels, and the seconds it took."""
    from repro_torch.launch.hlo_stats import collective_bytes, records
    dry.reset()
    mesh_lib.CALLS.clear()
    mesh_lib.BYTES.clear()
    args = _storages(low.arguments)
    count = _Count(args)
    flops = FlopCounterMode(display=False)
    t0 = clock()
    ctx = torch.enable_grad() if low.grad else torch.no_grad()
    with ctx, flops, count:
        out = low.run()
    seconds = clock() - t0
    kernels = dry.snapshot()
    coll = collective_bytes(records(mesh_lib.CALLS, mesh_lib.BYTES))
    outs = _storages(out)
    del out
    return {
        "seconds": seconds,
        "flops": float(flops.get_total_flops()
                       + sum(k["flops"] for k in kernels.values())),
        "bytes": float(count.bytes + sum(k["bytes"]
                                         for k in kernels.values())),
        "collectives": coll,
        "memory": {
            "argument_bytes": sum(args.values()),
            "output_bytes": sum(outs.values()),
            "temp_bytes": count.peak,
            "alias_bytes": (sum(_storages(low.donated).values())
                            if low.donated is not None else 0),
        },
        "kernels": kernels,
        "ops": count.ops,
    }


def analyze(name: str, lowered: Lowered, lower_s: float) -> Dict[str, Any]:
    m = measure(lowered)
    rec = {
        "step": name,
        "lower_s": round(lower_s + m["seconds"], 2),
        "compile_s": 0.0,
        # one rank's program: per device, as the reference's SPMD numbers
        "flops_per_device": m["flops"],
        "bytes_per_device": m["bytes"],
        "collectives": m["collectives"],
        "memory": m["memory"],
        "kernels": m["kernels"],
        "hlo_chars": 0,            # the eager port has no HLO
        "aten_ops": m["ops"],
    }
    mem = rec["memory"]
    print(f"  {name}: trace {rec['lower_s']:.1f}s | "
          f"flops/dev {rec['flops_per_device']:.3e} | "
          f"bytes/dev {rec['bytes_per_device']:.3e} | "
          f"coll {m['collectives'].get('total', 0):.3e}B | "
          f"mem arg={mem['argument_bytes'] / 2**30:.2f}GiB "
          f"temp={mem['temp_bytes'] / 2**30:.2f}GiB")
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             donate: bool = True, analysis: Optional[bool] = None,
             rank: int = 0) -> Dict[str, Any]:
    mesh = _mesh(multi_pod, rank)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    print(f"[dryrun] {arch} × {shape_name} × {mesh_name} (rank {rank})")
    t_start = clock()
    if analysis is None:
        analysis = not multi_pod   # the split by unit: single-pod only
    cfg = None
    if arch == "hazy-view":
        lowered_map, n, d = lower_hazy_cell(shape_name, mesh)
        meta = {"entities": n, "feature_dim": d}
        analysis = False
    else:
        lowered_map, cfg, shape = lower_lm_cell(arch, shape_name, mesh,
                                                donate)
        meta = {"family": cfg.family, "seq_len": shape.seq_len,
                "global_batch": shape.global_batch, "kind": shape.kind}
    steps = [analyze(name, low, ts) for name, (low, ts) in
             lowered_map.items()]
    if analysis and cfg is not None:
        from repro_torch.launch.analysis import corrected_cell_metrics
        from repro_torch.models import build
        full = {"flops": steps[0]["flops_per_device"],
                "bytes": steps[0]["bytes_per_device"],
                "coll": steps[0]["collectives"].get("total", 0)}
        corr = corrected_cell_metrics(build(cfg), shape, mesh, full,
                                      shape.kind)
        steps[0]["loop_corrected"] = corr
        c = corr["corrected"]
        print(f"  by unit: flops/dev {c['flops']:.3e} | "
              f"bytes/dev {c['bytes']:.3e} | coll {c['coll']:.3e}B")
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "num_devices": mesh.size(mesh.axis_names), "rank": rank,
        "meta": meta, "steps": steps,
        "total_s": round(clock() - t_start, 1),
        "ok": True,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-donate", action="store_true")
    args = ap.parse_args(argv)
    rec = run_cell(args.arch, args.shape, args.multipod, args.out,
                   donate=not args.no_donate, rank=args.rank)
    print(json.dumps({k: v for k, v in rec.items() if k != "steps"}))


if __name__ == "__main__":
    main()
