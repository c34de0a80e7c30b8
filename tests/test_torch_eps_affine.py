"""The port's `ops.eps_affine` (plain PyTorch on the CPU) against the JAX
package's Pallas `eps_affine` run in interpret mode, at the shapes of
tests/test_kernels.py. eps within 2e-4 (f32) or 2e-2 (bf16); labels and
the count exact for f32, and for bf16 under the reference test's rule
(labels may differ only where |eps| < 1e-2, the count by at most as many).
The plain version against the JAX oracle: eps within the fp32 rounding
bound of a dot summed in two orders, labels and the count exact. The CUDA
kernel itself is held against the same plain version on the card by
chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from repro.kernels.eps_affine.ops import eps_affine as jax_eps  # noqa: E402
from repro.kernels.eps_affine.ref import (                  # noqa: E402
    eps_affine_ref as jax_eps_ref)

from repro_torch.kernels.checks import MAX_SMEM            # noqa: E402
from repro_torch.kernels.eps_affine import kernel, ops      # noqa: E402
from repro_torch.kernels.eps_affine.kernel import tile_plan  # noqa: E402
from repro_torch.kernels.eps_affine.ref import (            # noqa: E402
    eps_affine_ref, eps_affine_tiled_ref)

TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(n, d, dtype, seed):
    r = np.random.default_rng(seed)
    F = r.normal(size=(n, d)).astype(np.float32)
    w = r.normal(size=d).astype(np.float32)
    b = np.float32(r.normal())
    if dtype == "bf16":           # both sides round the same f32 values
        return (torch.tensor(F).to(torch.bfloat16),
                jnp.asarray(F, jnp.bfloat16), w, b)
    return torch.tensor(F), jnp.asarray(F), w, b


@pytest.mark.parametrize("n,d", [(256, 54), (1000, 128), (513, 300)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_eps_affine_equals_pallas(n, d, dtype):
    Ft, Fj, w, b = _inputs(n, d, dtype, n + d)
    eps, lab, cnt = ops.eps_affine(Ft, torch.tensor(w), float(b))
    je, jl, jc = jax_eps(Fj, jnp.asarray(w), jnp.float32(b), block_n=256,
                         interpret=True)
    je, jl = np.asarray(je), np.asarray(jl)
    assert eps.dtype == torch.float32 and eps.shape == (n,)
    assert lab.dtype == torch.int8 and cnt.dtype == torch.int32
    assert cnt.shape == ()
    np.testing.assert_allclose(eps.numpy(), je, **TOL[dtype])
    disagree = lab.numpy() != jl
    if dtype == "f32":
        assert not disagree.any()
        assert int(cnt) == int(jc)
    else:
        assert np.all(np.abs(je[disagree]) < 1e-2)
        assert abs(int(cnt) - int(jc)) <= int(disagree.sum())
    # the outputs agree with each other, as the fused kernel's do
    assert np.array_equal(lab.numpy(), np.where(eps.numpy() >= 0, 1, -1))
    assert int(cnt) == int((eps >= 0).sum())


ROUNDING_C = 2             # two fp32 sums of the same terms, each off by
                           # at most (terms) · 2⁻²⁴ · Σ|term| from exact


def _oracle_case(n, d, seed):
    """The plain form against the JAX oracle on one table: eps within the
    fp32 rounding bound of a (d + 1)-term sum taken in two orders,
    |got − want| ≤ ROUNDING_C · (d + 1) · 2⁻²⁴ · (Σ_i |F_i·w_i| + |b|)
    a row; labels and the count exactly equal."""
    r = np.random.default_rng(seed)
    F = r.normal(size=(n, d)).astype(np.float32)
    w = r.normal(size=d).astype(np.float32)
    b = np.float32(0.25)
    eps, lab, cnt = eps_affine_ref(torch.tensor(F), torch.tensor(w),
                                   torch.tensor(b))
    je, jl, jc = jax_eps_ref(jnp.asarray(F), jnp.asarray(w), b)
    mass = np.abs(F.astype(np.float64) * w.astype(np.float64)).sum(1)
    bound = ROUNDING_C * (d + 1) * 2.0 ** -24 * (mass + abs(float(b)))
    diff = np.abs(eps.numpy().astype(np.float64) - np.asarray(je, np.float64))
    assert (diff <= bound).all(), float((diff / bound).max())
    assert np.array_equal(lab.numpy(), np.asarray(jl))
    assert int(cnt) == int(jc)


def test_plain_version_equals_jax_oracle():
    """A 40-term dot: the two sums round up to 2.9e-6 apart (a row whose
    Σ|F_i·w_i| is 36.5), 1.6% of the bound; a fixed 1e-6 limit sits
    under fp32 rounding and passed or failed with the host's BLAS."""
    _oracle_case(300, 40, 5)


def test_plain_version_equals_jax_oracle_at_dblife_width():
    """d = 1024, DBLife's hashed width, where the rounding is largest."""
    _oracle_case(300, 1024, 6)


def test_no_quiet_fallback():
    """The CUDA wrapper takes CUDA tensors only, and the public wrapper
    gives a device it has no kernel for an error, not the CPU version."""
    F = torch.zeros(64, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.eps_affine(F, torch.zeros(8), torch.zeros(()))
    from torch_stand_in import OtherDevice
    with pytest.raises(ValueError, match="no eps_affine"):
        ops.eps_affine(OtherDevice(64, 8), OtherDevice(8), 0.0)
    assert kernel.eps_affine.launches == 0


@pytest.mark.parametrize("n", [1, 7, 513, 582_000])
@pytest.mark.parametrize("d", [53, 54, 300, 1024, 4096])
@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
def test_tile_plan_covers_every_row_once(n, d, itemsize):
    """Block i walks tiles i, i + grid, ...: every tile once, then the tail;
    each bulk copy starts and ends on 16 bytes; the ring and w fit the
    block's shared memory, and the grid one or two blocks an SM."""
    p = tile_plan(n, d, itemsize)
    assert p.tiles * p.rows_per_tile + p.tail == n
    assert 0 <= p.tail < p.rows_per_tile
    seen = np.zeros(p.tiles, np.int64)
    for block in range(p.grid):
        seen[block::p.grid] += 1
    assert (seen == 1).all()
    assert p.tile_bytes == p.rows_per_tile * d * itemsize
    assert p.tile_bytes % 16 == 0
    offsets = np.arange(p.tiles, dtype=np.int64) * p.tile_bytes
    assert (offsets % 16 == 0).all()
    assert 16 * 1024 <= p.tile_bytes <= 64 * 1024 or d * itemsize > 32768
    assert p.smem_bytes == p.stages * p.tile_bytes + 4 * d
    assert p.smem_bytes * p.blocks_per_sm <= MAX_SMEM
    assert p.stages >= 2 and p.blocks_per_sm in (1, 2)
    assert 1 <= p.grid <= 132 * p.blocks_per_sm
    assert p.grid <= max(1, p.tiles)
    assert p.chunk_bytes in (16, itemsize)
    assert (d * itemsize) % p.chunk_bytes == 0
    assert p.lanes in (4, 8, 16, 32)


@pytest.mark.parametrize("n,d", [(1, 54), (513, 300), (124_000, 1024)])
def test_tile_plan_without_alignment_reads_rows(n, d):
    """A base that is not 16-byte aligned copies no tile: every row is read
    with ordinary loads, spread over the grid."""
    p = tile_plan(n, d, 4, aligned=False)
    aligned = tile_plan(n, d, 4)
    assert p.tiles == 0 and p.tail == n
    assert 1 <= p.grid <= 132 * p.blocks_per_sm
    assert p.rows_per_tile == aligned.rows_per_tile


def test_tile_plan_refuses_rows_past_shared_memory():
    assert tile_plan(10, 16_384, 4).blocks_per_sm == 1
    with pytest.raises(ValueError, match="shared memory"):
        tile_plan(10, 20_000, 4)
    with pytest.raises(ValueError):
        tile_plan(10, 0, 4)


@pytest.mark.parametrize("n,d", [(256, 54), (1000, 128), (513, 300)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tiled_form_equals_pallas(n, d, dtype):
    """The plain form that walks the kernel's tile plan (tiles by block,
    then the tail, each dot in its lanes' order) against the Pallas kernel
    in interpret mode, under the rules of test_eps_affine_equals_pallas;
    and against the direct form."""
    Ft, Fj, w, b = _inputs(n, d, dtype, 2 * n + d)
    wt, bt = torch.tensor(w), torch.tensor(b)
    plan = tile_plan(n, d, Ft.element_size())
    eps, lab, cnt = eps_affine_tiled_ref(Ft, wt, bt, plan)
    je, jl, jc = jax_eps(Fj, jnp.asarray(w), jnp.float32(b), block_n=256,
                         interpret=True)
    je, jl = np.asarray(je), np.asarray(jl)
    np.testing.assert_allclose(eps.numpy(), je, **TOL[dtype])
    disagree = lab.numpy() != jl
    if dtype == "f32":
        assert not disagree.any() and int(cnt) == int(jc)
    else:
        assert np.all(np.abs(je[disagree]) < 1e-2)
        assert abs(int(cnt) - int(jc)) <= int(disagree.sum())
    assert int(cnt) == int((lab == 1).sum())
    de, dl, dc = eps_affine_ref(Ft, wt, bt)
    np.testing.assert_allclose(eps.numpy(), de.numpy(), rtol=1e-5,
                               atol=1e-5)
    # a base that is not 16-byte aligned: every row read as the tail
    ue, ul, uc = eps_affine_tiled_ref(
        Ft, wt, bt, tile_plan(n, d, Ft.element_size(), aligned=False))
    np.testing.assert_allclose(ue.numpy(), de.numpy(), rtol=1e-5, atol=1e-5)
    assert int(uc) == int((ul == 1).sum())
