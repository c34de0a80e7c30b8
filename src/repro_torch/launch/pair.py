"""Build a kernel source of this tree and of another tree side by side and
time them in turns on one GPU: the machinery of `wkv6_pair` and
`mv_band_pair`.

Each tree's `src/repro_torch/csrc/<name>.cu` is compiled by nvcc with this
tree's flags into `build/pair/lib<name>-<tag>.so` and loaded with ctypes,
its C signatures taken from that tree's own `kernels/build.py` (a module
of the standard library alone, loaded by path), so a tree whose C entry
differs from this one's loads as it was written. Times are CUDA-event
medians, each launch after 256 MB were zeroed (the L2 cache cold, as
`chip_smoke.py` times kernels).
"""
from __future__ import annotations

import ctypes
import importlib.util
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build

ORDER = ("other", "this", "this", "other")     # A, B, B, A


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _signatures(root: Path, name: str) -> dict:
    path = root / "src" / "repro_torch" / "kernels" / "build.py"
    spec = importlib.util.spec_from_file_location(
        f"_pair_build_{abs(hash(str(path.resolve())))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SIGNATURES[name]


def build_kernel(root: Path, name: str, tag: str, flags=()) -> ctypes.CDLL:
    """Compile `root`'s csrc/<name>.cu and load it with `root`'s C
    signatures."""
    src = root / "src" / "repro_torch" / "csrc" / f"{name}.cu"
    lib = build.BUILD_DIR.parent / "pair" / f"lib{name}-{tag}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(lib),
           str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{done.stdout}"
                           f"{done.stderr}")
    out = ctypes.CDLL(str(lib))
    for fn, (restype, argtypes) in _signatures(root, name).items():
        getattr(out, fn).restype = restype
        getattr(out, fn).argtypes = argtypes
    return out


def events_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median CUDA-event time of `fn` over `reps` launches, each after
    `flush` was zeroed; one warm-up launch first."""
    fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        marks.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in marks]))


def flush_buffer(device) -> torch.Tensor:
    return torch.empty(256 << 20, dtype=torch.uint8, device=device)
