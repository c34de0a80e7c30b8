"""Build and load the port's hand-written CUDA kernels.

Each source `repro_torch/csrc/<name>.cu` exposes a plain C interface. At
first use it is compiled by `nvcc` for `sm_90a` into a shared library
under `<checkout>/build/kernels/` (the file name carries a hash of the
source, the shared headers `csrc/*.cuh` and the flags, so an edited source
or header builds anew) and loaded with `ctypes`. No PyTorch header is
compiled, which keeps a build to seconds. `build.builds` counts the
`nvcc` runs of the process; each is a `kernels.build` span under the
thread's current span, if any (`obs.trace`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

from repro_torch.obs.trace import Span, clock, current

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
# C signatures per source: function -> (restype, argtypes). Every pointer
# and the stream are c_void_p, or ctypes would pass them as 32-bit ints.
SIGNATURES = {
    "band_reclassify": {
        "mv_band_reclassify": (
            ctypes.c_int,
            [_P] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 7 + [_P]),
        "band_reclassify": (
            ctypes.c_int,
            [_P, _P, _P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
            + [ctypes.c_int] * 5 + [_P]),
        "band_reclassify_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "eps_affine": {
        "eps_affine": (
            ctypes.c_int,
            [_P] * 8 + [ctypes.c_int64] + [ctypes.c_int] * 6 + [_P]),
        "eps_affine_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "flash_attention": {
        "flash_attention": (
            ctypes.c_int,
            [_P] * 5 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 9
            + [ctypes.c_float, ctypes.c_int, _P]),
        "flash_attention_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "flash_attention_bwd": {
        "flash_attention_bwd": (
            ctypes.c_int,
            [_P] * 10 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 12
            + [ctypes.c_float, ctypes.c_int, _P]),
        "flash_attention_bwd_error_string": (ctypes.c_char_p,
                                             [ctypes.c_int]),
        "flash_attention_bwd_wgmma_calls": (ctypes.c_longlong, []),
    },
    "decode_attention": {
        "decode_attention": (
            ctypes.c_int,
            [_P] * 6 + [ctypes.c_int] * 7 + [ctypes.c_int64] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, _P]),
        "decode_attention_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "wkv6": {
        "wkv6": (
            ctypes.c_int,
            [_P] * 6 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 12 + [_P]),
        "wkv6_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "wkv6_bwd": {
        "wkv6_bwd": (
            ctypes.c_int,
            [_P] * 13 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 15 + [_P]),
        "wkv6_bwd_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile each named source (default: every one) that is not built
    yet, one `nvcc` per source, all started together. Returns the
    compiler's messages per source ("" when it was already built)."""
    names = sorted(SIGNATURES) if names is None else list(names)
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    logs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            logs[name] = ""
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        sp = Span("kernels.build", clock(), attrs={"source": name})
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib, sp)
    failed = []
    parent = current()
    for name, (proc, tmp, lib, sp) in jobs.items():
        out, _ = proc.communicate()
        sp.t1 = clock()            # the runs overlap: spans off the stack
        if parent is not None:
            parent.children.append(sp)
        build.builds += 1
        logs[name] = out
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, lib)       # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


build.builds = 0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, built first if need be."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib
