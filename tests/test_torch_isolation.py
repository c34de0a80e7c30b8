"""The port stands alone: every module of `repro_torch`, and chip_smoke.py,
imports with `jax` and `repro` made unimportable; and its entry points
refuse to run on the CPU unless asked to."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_port_imports_without_jax_or_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any import of them now fails
        sys.modules["repro"] = None
        sys.path.insert(0, "src")
        sys.path.insert(0, ".")
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m, mod in sys.modules.items() if mod is not None)
        print(len(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip()) >= 15       # every module was walked


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    from repro_torch.core.facade import make_sharded_facade
    from repro_torch.core.sharded import ShardedMultiViewHazy
    F = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sharded_facade(F, 7)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedMultiViewHazy(n=64, d=8, k=7, M=1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sharded_facade(F, 7, device="cuda")
    fac = make_sharded_facade(F, 7, device="cpu")   # asked for: runs
    assert fac.state.F.device.type == "cpu"


def test_single_view_engine_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    from repro_torch.core.sharded import ShardedHazy
    from repro_torch.core.waters import holder_M
    F = np.random.default_rng(1).normal(size=(256, 8)).astype(np.float32)
    M = holder_M(F, 2.0)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedHazy(n=256, d=8, M=M, device=device)
    sh = ShardedHazy(n=256, d=8, M=M, device="cpu")      # asked for: runs
    state = sh.init_state(F)
    assert state.F.device.type == "cpu" and sh.cap == 64
    w = np.random.default_rng(2).normal(size=8).astype(np.float32)
    state = sh.apply_model(state, w, 0.1)
    truth = np.where(F @ w - np.float32(0.1) >= 0, 1, -1)
    assert np.array_equal(sh.labels_in_entity_order(state), truth)
