"""Run one program as several `torch.distributed` ranks on the CPU, for
the port's multi-rank tests (`tests/test_torch_distributed.py`,
`tests/test_torch_sharded_mesh.py`), and the reference's multi-device
programs beside them.

Each rank is a subprocess with `RANK` and `WORLD_SIZE` set, gloo over a
`file://` rendezvous in the test's temporary directory (no TCP port to
clash under xdist), a 60 s timeout on every collective, one torch thread
and `OMP_NUM_THREADS=1`. Its output goes to a file, not a pipe, so no
rank blocks on a full pipe while another waits in a collective. Every
wait has a deadline; a rank that fails or runs out of time fails the
call, and the others are killed.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import time

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

PRELUDE = """
import os, pickle
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.launch.mesh import init_process_group
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
init_process_group("cpu", init_method=os.environ["RANKS_INIT"],
                   timeout=timedelta(seconds=60))
OUT = {}
"""

EPILOGUE = """
with open(os.path.join(os.environ["RANKS_DIR"], f"out{RANK}.pkl"),
          "wb") as _f:
    pickle.dump(OUT, _f)
dist.destroy_process_group()
"""


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra or {})
    return env


class Ranks:
    """`world` ranks started together: `Ranks(code=...)` runs PRELUDE +
    code + EPILOGUE (the code fills `OUT`); `Ranks(argv=[...])` runs a
    command with the rank's environment and `RANKS_INIT` set to the
    rendezvous. `result(timeout)` waits for all."""

    def __init__(self, directory, world, *, code=None, argv=None, env=None):
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)
        init = "file://" + os.path.join(self.dir, "rendezvous")
        if code is not None:
            argv = [sys.executable, "-c",
                    PRELUDE + textwrap.dedent(code) + EPILOGUE]
        self.procs, self.logs = [], []
        for r in range(world):
            log = open(os.path.join(self.dir, f"log{r}.txt"), "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                argv, stdout=log, stderr=subprocess.STDOUT,
                env=_env(dict(env or {}, RANK=str(r), WORLD_SIZE=str(world),
                              LOCAL_RANK=str(r), RANKS_INIT=init,
                              RANKS_DIR=self.dir))))

    def wait(self, timeout):
        """Every rank's (exit code, output); kills all at the deadline."""
        deadline = time.monotonic() + timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            for p in self.procs:
                p.wait(timeout=30)
            raise AssertionError(f"ranks ran past {timeout} s:\n"
                                 + self._tail())
        finally:
            for log in self.logs:
                log.close()
        return [(p.returncode, self._log(r))
                for r, p in enumerate(self.procs)]

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)

    def _log(self, r):
        with open(os.path.join(self.dir, f"log{r}.txt")) as f:
            return f.read()

    def _tail(self):
        return "\n".join(f"--- rank {r}\n{self._log(r)[-1500:]}"
                         for r in range(len(self.procs)))

    def result(self, timeout):
        """Each rank's `OUT`, in rank order; raises unless all exited 0."""
        done = self.wait(timeout)
        bad = [r for r, (rc, _) in enumerate(done) if rc]
        assert not bad, f"ranks {bad} failed:\n" + self._tail()
        outs = []
        for r in range(len(self.procs)):
            with open(os.path.join(self.dir, f"out{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs


class Reference:
    """A reference program in a subprocess with `devices` fake CPU
    devices (`XLA_FLAGS`); it writes `OUT` (a dict) with pickle. The
    multi-view driver's `shard_map(..., check_rep=False)` is renamed to
    `check_vma` for this host's jax inside the subprocess only (the R1
    shim of tests/test_torch_sharded.py)."""

    SHIM = """
import numpy as np
import repro.core.sharded as _ref_sharded
_orig = _ref_sharded.shard_map
def _shim(*a, **kw):
    if "check_rep" in kw:
        kw["check_vma"] = kw.pop("check_rep")
    return _orig(*a, **kw)
_ref_sharded.shard_map = _shim
OUT = {}
"""

    def __init__(self, directory, code, devices=8):
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.out = os.path.join(self.dir, "reference.pkl")
        self.log = open(os.path.join(self.dir, "reference.txt"), "w")
        body = (self.SHIM + textwrap.dedent(code)
                + f"\nimport pickle\nwith open({self.out!r}, 'wb') as _f:"
                  "\n    pickle.dump(OUT, _f)\n")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", body], stdout=self.log,
            stderr=subprocess.STDOUT, env=_env({
                "XLA_FLAGS":
                    f"--xla_force_host_platform_device_count={devices}",
                "JAX_PLATFORMS": "cpu"}))

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)

    def result(self, timeout):
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)
            raise AssertionError(f"the reference ran past {timeout} s")
        finally:
            self.log.close()
        with open(os.path.join(self.dir, "reference.txt")) as f:
            log = f.read()
        assert self.proc.returncode == 0, log[-3000:]
        with open(self.out, "rb") as f:
            return pickle.load(f)
