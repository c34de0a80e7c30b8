"""The port's `ops.multiview_band_reclassify` (plain PyTorch on the CPU)
against the JAX package's Pallas kernel run in interpret mode, at the
shapes and windows of tests/test_kernels.py. int8 labels and overflow
flags must be exactly equal. The CUDA kernel itself is held against the
same plain version on the card by chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from repro.kernels.band_reclassify import ops as ref_ops    # noqa: E402
from repro.kernels.band_reclassify.ref import (             # noqa: E402
    multiview_band_reclassify_ref as jax_ref)

from repro_torch.kernels.band_reclassify import kernel, ops  # noqa: E402
from repro_torch.kernels.band_reclassify.ref import (       # noqa: E402
    multiview_band_reclassify_ref)


def _inputs(k, n, d, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, d)).astype(np.float32),
            (r.integers(0, 2, (k, n)) * 2 - 1).astype(np.int8),
            r.normal(size=(k, d)).astype(np.float32),
            r.normal(size=k).astype(np.float32), r)


def _port(F, labels, W, b, starts, ends, **kw):
    lab = torch.tensor(labels)
    out = ops.multiview_band_reclassify(
        torch.tensor(F), lab, torch.tensor(W), torch.tensor(b),
        torch.tensor(starts), torch.tensor(ends), **kw)
    return out


def _jax(F, labels, W, b, starts, ends, **kw):
    return ref_ops.multiview_band_reclassify(
        jnp.asarray(F), jnp.asarray(labels), jnp.asarray(W), jnp.asarray(b),
        jnp.asarray(starts, jnp.int32), jnp.asarray(ends, jnp.int32),
        interpret=True, **kw)


@pytest.mark.parametrize("k,n,d", [(4, 2048, 64), (7, 2048, 128),
                                   (16, 4096, 32)])
def test_multiview_sweep_equals_pallas(k, n, d):
    F, labels, W, b, r = _inputs(k, n, d, k)
    starts = r.integers(0, n, k).astype(np.int32)
    ends = np.minimum(starts + r.integers(0, 1500, k), n).astype(np.int32)
    got = _port(F, labels, W, b, starts, ends, cap=2048, block_n=256)
    want = _jax(F, labels, W, b, starts, ends, cap=2048, block_n=256)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), labels)   # windows were relabeled


def test_overflow_flag_equals_pallas():
    k, n, d, cap, block_n = 3, 2048, 32, 512, 256
    F, labels, W, b, _ = _inputs(k, n, d, 1)
    starts = np.array([256, 256, 0], np.int32)
    ends = np.array([256 + cap + 1, 256 + cap, 0], np.int32)
    got, over = _port(F, labels, W, b, starts, ends, cap=cap,
                      block_n=block_n, with_overflow=True)
    want, want_over = _jax(F, labels, W, b, starts, ends, cap=cap,
                           block_n=block_n, with_overflow=True)
    assert over.tolist() == [True, False, False]
    assert np.array_equal(over.numpy(), np.asarray(want_over))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got[2].numpy(), labels[2])   # empty window
    # the default call returns the labels alone, updated in place
    lab = torch.tensor(labels)
    out = ops.multiview_band_reclassify(
        torch.tensor(F), lab, torch.tensor(W), torch.tensor(b),
        torch.tensor(starts), torch.tensor(ends), cap=cap, block_n=block_n)
    assert out is lab and np.array_equal(lab.numpy(), got.numpy())


def test_single_view_equals_pallas_single_view_kernel():
    """k = 1 through the port == the reference's single-view kernel."""
    n, d = 2048, 64
    F, labels, W, _, _ = _inputs(1, n, d, 2)
    F = np.sort(F, axis=0)
    single = ref_ops.band_reclassify(jnp.asarray(F), jnp.asarray(labels[0]),
                                     jnp.asarray(W[0]), 0.1, 300, 900,
                                     cap=1024, block_n=256, interpret=True)
    got = _port(F, labels, W, np.array([0.1], np.float32),
                np.array([300], np.int32), np.array([900], np.int32),
                cap=1024, block_n=256)
    assert np.array_equal(got[0].numpy(), np.asarray(single))


@pytest.mark.parametrize("starts,ends", [
    ([0, 512, 1024, 256], [0, 512, 1000, 0]),              # empty windows
    ([1900, 2047, 1500, 0], [2048, 2048, 2048, 2048]),     # clamped
])
def test_plain_version_equals_jax_oracle(starts, ends):
    k, n, d, cap, block_n = 4, 2048, 64, 1024, 256
    F, labels, W, b, _ = _inputs(k, n, d, 3)
    starts = np.array(starts, np.int32)
    ends = np.array(ends, np.int32)
    sb = np.clip(starts // block_n, 0, (n - cap) // block_n).astype(np.int32)
    widths = np.clip(ends - sb * block_n, 0, cap).astype(np.int32)
    got = multiview_band_reclassify_ref(
        torch.tensor(F), torch.tensor(labels), torch.tensor(W),
        torch.tensor(b), torch.tensor(sb), torch.tensor(widths), cap=cap,
        block_n=block_n)
    want = jax_ref(jnp.asarray(F), jnp.asarray(labels), jnp.asarray(W),
                   jnp.asarray(b), jnp.asarray(sb), jnp.asarray(widths),
                   cap=cap, block_n=block_n)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_no_quiet_fallback():
    """The CUDA wrapper takes CUDA tensors only, and the public wrapper
    gives a device it has no kernel for an error, not the CPU version."""
    F, labels, W, b, _ = _inputs(2, 512, 8, 4)
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.multiview_band_reclassify(
            torch.tensor(F), torch.tensor(labels), torch.tensor(W),
            torch.tensor(b), z, z, cap=256, block_n=256)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no band_reclassify"):
        ops.multiview_band_reclassify(
            torch.empty(512, 8, device=meta),
            torch.empty(2, 512, dtype=torch.int8, device=meta),
            torch.empty(2, 8, device=meta), torch.empty(2, device=meta),
            [0, 0], [0, 0], cap=256, block_n=256)
    assert kernel.multiview_band_reclassify.launches == 0
