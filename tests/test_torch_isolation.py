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
        print(" ".join(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    walked = set(out.stdout.split())
    assert len(walked) >= 50                   # every module was walked
    assert {"repro_torch.configs.registry", "repro_torch.models.transformer",
            "repro_torch.models.steps", "repro_torch.launch.serve",
            "repro_torch.obs", "repro_torch.kernels.flash_attention.kernel",
            "repro_torch.kernels.decode_attention.kernel",
            "repro_torch.obs.metrics", "repro_torch.obs.trace",
            "repro_torch.obs.cost", "repro_torch.core.hazy",
            "repro_torch.core.multiview", "repro_torch.core.view",
            "repro_torch.core.multiclass", "repro_torch.core.random_features",
            "repro_torch.launch.view_driver", "repro_torch.storage",
            "repro_torch.storage.store", "repro_torch.storage.pool",
            "repro_torch.storage.prefetch", "repro_torch.analysis",
            "repro_torch.analysis.witness"} <= walked


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


def test_host_engines_and_views_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    from repro_torch.core import (ClassificationView, HazyEngine,
                                  MulticlassView, MultiViewEngine,
                                  NaiveEngine)
    from repro_torch.launch import serve, view_driver
    F = np.random.default_rng(3).normal(size=(64, 8)).astype(np.float32)
    builds = [lambda d: HazyEngine(F, device=d),
              lambda d: NaiveEngine(F, device=d),
              lambda d: MultiViewEngine(F, 3, device=d),
              lambda d: ClassificationView(F, device=d),
              lambda d: ClassificationView(F, engine="naive", device=d),
              lambda d: MulticlassView(F, 3, device=d),
              lambda d: MulticlassView(F, 3, vectorized=False, device=d),
              lambda d: view_driver.make_backbone_encoder(device=d)]
    for make in builds:
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make(device)
        make("cpu")                                       # asked for: runs
    for argv in (["--mode", "view", "--requests", "4"],
                 ["--mode", "view", "--requests", "4", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        view_driver.serve_view(requests=4, docs=8, doc_len=4)


def test_storage_engines_and_layer2_raise_without_a_gpu():
    """An engine over a storage tier and Layer 2's `init_state` follow the
    same rule: the GPU unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    from repro_torch.core import engine, HazyEngine, MultiViewEngine
    from repro_torch.storage import BufferPool, EntityStore
    F = np.random.default_rng(4).normal(size=(64, 8)).astype(np.float32)
    store = EntityStore.from_array(F, page_bytes=128)
    params = engine.make_params(F)
    builds = [lambda d: HazyEngine(F, store=BufferPool(store, 1024),
                                   policy="hybrid", buffer_frac=0.1,
                                   device=d),
              lambda d: MultiViewEngine(F, 3, store=BufferPool(store, 1024),
                                        device=d),
              lambda d: engine.init_state(F, 3, params, device=d)]
    for make in builds:
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make(device)
        make("cpu")                                       # asked for: runs
    store.close()


def test_lm_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    from repro_torch.configs import smoke_config
    from repro_torch.core.convert import params_from_reference
    from repro_torch.launch.serve import serve_decode
    from repro_torch.models import build
    from repro_torch.models.steps import init_cache, init_serving_params
    mdl = build(smoke_config("tinyllama-1.1b"))
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_decode("tinyllama-1.1b", 2, 1, 4, smoke=True,
                         device=device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_serving_params(mdl, device=device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_cache(mdl, 1, 4, device=device)
    params = init_serving_params(mdl, device="cpu")       # asked for: runs
    assert params["tok"]["embedding"].device.type == "cpu"
    as_np = {"final_norm": {"scale": np.ones(mdl.cfg.d_model, np.float32)}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_reference(as_np, mdl.cfg)
    run = serve_decode("tinyllama-1.1b", 2, 1, 4, smoke=True, device="cpu")
    assert run.tokens.shape == (1, 2) and run.tokens.device.type == "cpu"


def test_lm_stack_does_not_load_the_classification_engine():
    """The LM layers take their device rule from `repro_torch.device`, not
    from the Hazy engine: importing the serving path loads neither
    `core.sharded` nor the band/eps kernels."""
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, "src")
        import repro_torch.launch.serve, repro_torch.models.steps
        from repro_torch.launch.serve import serve_decode
        loaded = [m for m in sys.modules if m.startswith(
            ("repro_torch.core", "repro_torch.kernels.band_reclassify",
             "repro_torch.kernels.eps_affine"))]
        assert not loaded, loaded
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
