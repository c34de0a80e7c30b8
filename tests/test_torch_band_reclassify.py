"""The port's `ops.multiview_band_reclassify` and single-view
`ops.band_reclassify` (plain PyTorch on the CPU) against the JAX package's
Pallas kernels run in interpret mode, at the shapes and windows of
tests/test_kernels.py. int8 labels and overflow flags must be exactly
equal. The CUDA kernels themselves are held against the same plain
versions on the card by chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from repro.kernels.band_reclassify import ops as ref_ops    # noqa: E402
from repro.kernels.band_reclassify.ref import (             # noqa: E402
    multiview_band_reclassify_ref as jax_ref)

from repro_torch.kernels.band_reclassify import kernel, ops  # noqa: E402
from repro_torch.kernels.band_reclassify.kernel import (    # noqa: E402
    BAND_RESIDENT, BAND_THREADS, BLOCK_SMEM_RESERVED, MAX_LOADS, MAX_W_REGS,
    MV_RESIDENT, MV_THREADS, SM_SMEM, SMS, band_plan, multiview_plan,
    multiview_segments)
from repro_torch.kernels.band_reclassify.ref import (       # noqa: E402
    band_reclassify_planned_ref, band_reclassify_ref, band_reclassify_rows_ref,
    multiview_band_reclassify_planned_ref, multiview_band_reclassify_ref)
from repro_torch.kernels.checks import MAX_SMEM              # noqa: E402


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


@pytest.mark.parametrize("n,d,start,end", [
    (2048, 64, 300, 700), (2048, 64, 0, 1), (2048, 64, 1500, 2048),
    (4096, 200, 100, 4000),
])
def test_single_view_equals_pallas(n, d, start, end):
    """tests/test_kernels.py:39-61: the tile-aligned, capacity-clamped
    single-view wrapper, exactly equal to the Pallas kernel and to the
    numpy statement of its window."""
    r = np.random.default_rng(n + d + start)
    F = np.sort(r.normal(size=(n, d)), axis=0).astype(np.float32)
    labels = (r.integers(0, 2, n) * 2 - 1).astype(np.int8)
    w = r.normal(size=d).astype(np.float32)
    b, block_n = 0.1, 256
    cap = min(4096 if end - start > 1024 else 1024, n)
    lab = torch.tensor(labels)
    got = ops.band_reclassify(torch.tensor(F), lab, torch.tensor(w), b,
                              start, end, cap=cap, block_n=block_n)
    want = ref_ops.band_reclassify(jnp.asarray(F), jnp.asarray(labels),
                                   jnp.asarray(w), b, start, end, cap=cap,
                                   block_n=block_n, interpret=True)
    assert got is lab and got.dtype == torch.int8
    assert np.array_equal(got.numpy(), np.asarray(want))
    sb = min(max(0, start // block_n), max(0, (n - cap) // block_n))
    w0 = sb * block_n
    width = int(np.clip(end - w0, 0, cap))
    expect = labels.copy()
    z = F[w0:w0 + width] @ w - np.float32(b)
    expect[w0:w0 + width] = np.where(z >= 0, 1, -1)
    assert np.array_equal(got.numpy(), expect)


def test_single_view_equals_multiview_k1():
    """tests/test_kernels.py:120-133 on the port: a k = 1 multi-view call
    equals the single-view call on the same window."""
    n, d = 2048, 64
    F, labels, W, _, _ = _inputs(1, n, d, 6)
    F = np.sort(F, axis=0)
    single = ops.band_reclassify(torch.tensor(F), torch.tensor(labels[0]),
                                 torch.tensor(W[0]), 0.1, 300, 900,
                                 cap=1024, block_n=256)
    multi = _port(F, labels, W, np.array([0.1], np.float32),
                  np.array([300], np.int32), np.array([900], np.int32),
                  cap=1024, block_n=256)
    assert np.array_equal(single.numpy(), multi[0].numpy())
    assert not np.array_equal(single.numpy(), labels[0])


@pytest.mark.parametrize("start,width", [(0, 0), (17, 1), (333, 1000),
                                         (1000, 1048)])
def test_row_window_relabels_exactly_its_rows(start, width):
    """The banded step's row-granular window: rows [start, start + width)
    and no others, with no tile alignment."""
    n, d = 2048, 54
    F, labels, W, b, _ = _inputs(1, n, d, 7)
    lab = torch.tensor(labels[0])
    out = ops.band_reclassify_rows(torch.tensor(F), lab, torch.tensor(W[0]),
                                   float(b[0]), start, width)
    assert out is lab
    expect = labels[0].copy()
    z = F[start:start + width] @ W[0] - b[0]
    expect[start:start + width] = np.where(z >= 0, 1, -1)
    assert np.array_equal(out.numpy(), expect)
    plain = band_reclassify_rows_ref(
        torch.tensor(F), torch.tensor(labels[0]), torch.tensor(W[0]),
        torch.tensor(b[0]), start, width)
    assert np.array_equal(plain.numpy(), expect)


def test_no_quiet_fallback():
    """The CUDA wrapper takes CUDA tensors only, and the public wrapper
    gives a device it has no kernel for an error, not the CPU version."""
    F, labels, W, b, _ = _inputs(2, 512, 8, 4)
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.multiview_band_reclassify(
            torch.tensor(F), torch.tensor(labels), torch.tensor(W),
            torch.tensor(b), z, z, cap=256, block_n=256)
    from torch_stand_in import OtherDevice
    with pytest.raises(ValueError, match="no band_reclassify"):
        ops.multiview_band_reclassify(
            OtherDevice(512, 8), OtherDevice(2, 512, dtype=torch.int8),
            OtherDevice(2, 8), OtherDevice(2), [0, 0], [0, 0], cap=256,
            block_n=256)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.band_reclassify(torch.tensor(F), torch.tensor(labels[0]),
                               torch.tensor(W[0]), torch.tensor(b[0]), 0, 8)
    with pytest.raises(ValueError, match="no band_reclassify"):
        ops.band_reclassify_rows(
            OtherDevice(512, 8), OtherDevice(512, dtype=torch.int8),
            OtherDevice(8), 0.0, 0, 8)
    # past the multi-view kernel's limits the wrapper raises before it
    # looks at the device: more than 64 views, or W past shared memory
    with pytest.raises(ValueError, match="1 to 64 views"):
        kernel.multiview_band_reclassify(
            torch.zeros(512, 8), torch.zeros(65, 512, dtype=torch.int8),
            torch.zeros(65, 8), torch.zeros(65),
            torch.zeros(65, dtype=torch.int32),
            torch.zeros(65, dtype=torch.int32), cap=256, block_n=256)
    d = MAX_SMEM // (4 * 7) + 1
    with pytest.raises(ValueError, match="shared memory"):
        kernel.multiview_band_reclassify(
            torch.zeros(16, d), torch.zeros(7, 16, dtype=torch.int8),
            torch.zeros(7, d), torch.zeros(7),
            torch.zeros(7, dtype=torch.int32),
            torch.zeros(7, dtype=torch.int32), cap=16, block_n=16)
    assert kernel.multiview_band_reclassify.launches == 0
    assert kernel.band_reclassify.launches == 0


def _wave(d, itemsize, address=0):
    """Rows in flight in one wave: rows a block at most, times the grid."""
    lanes = band_plan(1, d, itemsize, address).lanes
    return BAND_THREADS // lanes * SMS * BAND_RESIDENT


@pytest.mark.parametrize("d", [53, 54, 300, 1024, 4096])
@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["0", "1", "wave-1", "wave", "wave+1",
                                  "full"])
@pytest.mark.parametrize("address", [0, 4], ids=["aligned", "offset4"])
def test_band_plan_covers_every_row_and_column_once(d, itemsize, case,
                                                    address):
    """Loop l, block g, group r take band row (l·grid + g)·rows + r: every
    row of the band once; lane s takes chunks s + k·lanes of each pass:
    every chunk of a row once; loads fit the lane's registers, the grid
    one wave, and a band of up to one wave needs one loop."""
    wave = _wave(d, itemsize, address)
    width = {"0": 0, "1": 1, "wave-1": wave - 1, "wave": wave,
             "wave+1": wave + 1, "full": 582_000}[case]
    p = band_plan(width, d, itemsize, address)
    rows = np.arange(p.loops * p.grid * p.rows_per_block)
    assert np.array_equal(rows[rows < width], np.arange(width))
    assert p.loops == (1 if 0 < width <= wave else p.loops)
    assert width == 0 or (p.loops - 1) * p.grid * p.rows_per_block < width
    assert 1 <= p.grid <= SMS * BAND_RESIDENT
    assert p.rows_per_block * p.lanes <= BAND_THREADS
    assert p.lanes & (p.lanes - 1) == 0
    assert p.chunk_bytes in (2, 4, 8, 16) and p.chunk_bytes >= itemsize
    assert (d * itemsize) % p.chunk_bytes == 0
    assert address % p.chunk_bytes == 0
    per = p.chunk_bytes // itemsize
    assert p.loads_per_lane <= MAX_LOADS
    assert p.loads_per_lane * per <= MAX_W_REGS
    chunks = d // per
    seen = np.zeros(chunks, np.int64)
    for pas in range(p.passes):
        for sub in range(p.lanes):
            j = pas * p.lanes * p.loads_per_lane + sub + \
                p.lanes * np.arange(p.loads_per_lane)
            np.add.at(seen, j[j < chunks], 1)
    assert (seen == 1).all()
    if d * itemsize % 16 == 0 and address == 0:
        assert p.chunk_bytes == 16       # 16-byte loads where they can be


@pytest.mark.parametrize("n,d,start,end", [
    (2048, 64, 300, 700), (2048, 64, 0, 1), (2048, 64, 1500, 2048),
    (4096, 200, 100, 4000),
])
def test_planned_form_equals_pallas(n, d, start, end):
    """The plain form that walks the single-view kernel's band plan (rows
    by loop and block, each dot in its lanes' order), behind the
    tile-aligned window arithmetic, against the Pallas kernel in
    interpret mode at tests/test_kernels.py's windows: equal labels."""
    r = np.random.default_rng(3 * n + d + start)
    F = np.sort(r.normal(size=(n, d)), axis=0).astype(np.float32)
    labels = (r.integers(0, 2, n) * 2 - 1).astype(np.int8)
    w = r.normal(size=d).astype(np.float32)
    b, block_n = 0.1, 256
    cap = min(4096 if end - start > 1024 else 1024, n)
    sb = min(max(0, start // block_n), max(0, (n - cap) // block_n))
    width = int(np.clip(end - sb * block_n, 0, cap))
    got = band_reclassify_planned_ref(
        torch.tensor(F), torch.tensor(labels), torch.tensor(w),
        torch.tensor(np.float32(b)), sb * block_n, width,
        band_plan(width, d, 4))
    want = ref_ops.band_reclassify(jnp.asarray(F), jnp.asarray(labels),
                                   jnp.asarray(w), b, start, end, cap=cap,
                                   block_n=block_n, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    tile = band_reclassify_ref(torch.tensor(F), torch.tensor(labels)[:, None],
                               torch.tensor(w), torch.tensor(np.float32(b)),
                               sb, width, cap=cap, block_n=block_n)[:, 0]
    assert np.array_equal(got.numpy(), tile.numpy())


@pytest.mark.parametrize("d,dtype", [(54, "f32"), (1024, "f32"),
                                     (1024, "bf16"), (53, "bf16")])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_planned_form_at_one_wave(d, dtype, edge):
    """Bands of one wave − 1, one wave and one wave + 1 rows (the last
    takes a second loop) through the planned form: the rows of the band
    are relabeled and no other, up to fp32 ties of the dot."""
    itemsize = 2 if dtype == "bf16" else 4
    width = _wave(d, itemsize) + edge
    n, start = width + 9, 5
    r = np.random.default_rng(d + edge + itemsize)
    F = torch.tensor(r.normal(size=(n, d)).astype(np.float32))
    if dtype == "bf16":
        F = F.to(torch.bfloat16)
    w = torch.tensor(r.normal(size=d).astype(np.float32))
    labels = torch.tensor((r.integers(0, 2, n) * 2 - 1).astype(np.int8))
    plan = band_plan(width, d, itemsize)
    assert plan.loops == (2 if edge > 0 else 1)
    got = band_reclassify_planned_ref(F, labels, w, torch.tensor(0.25),
                                      start, width, plan)
    z = F.double() @ w.double() - 0.25
    want = labels.clone()
    want[start:start + width] = torch.where(z[start:start + width] >= 0,
                                            1, -1).to(torch.int8)
    differ = (got != want).nonzero()[:, 0]
    assert bool((z[differ].abs() < 1e-4).all())
    assert np.array_equal(got[:start].numpy(), labels[:start].numpy())
    assert np.array_equal(got[start + width:].numpy(),
                          labels[start + width:].numpy())


def _mv_windows(kind, k, n, cap, block_n, rng):
    """Aligned windows (start_blocks, widths) of one kind, inside the
    table as `ops.multiview_band_reclassify` leaves them."""
    last = (n - cap) // block_n
    if kind == "disjoint":
        width = min(cap, n // k) // block_n * block_n
        return [v * width // block_n for v in range(k)], [width] * k
    if kind == "nested":              # from the front, as the path's
        return [0] * k, [cap * (v + 1) // k for v in range(k)]
    if kind == "identical":
        return [last // 2] * k, [cap // 3 + 5] * k
    if kind == "empty":
        return [int(x) for x in rng.integers(0, last + 1, k)], [0] * k
    # clamped at n − cap, some empty, widths up to cap
    return [last] * k, [int(x) for x in rng.integers(0, cap + 1, k)]


@pytest.mark.parametrize("k", [1, 2, 7, 64])
@pytest.mark.parametrize("kind", ["disjoint", "nested", "identical",
                                  "empty", "clamped"])
def test_multiview_plan_walks_every_window_row_once(k, kind):
    """The kernel's walk (`multiview_segments`, then loop l, block g,
    group r take flat row (l·grid + g)·rows + r) relabels every row of
    every window once for its view and no other row; the segments
    partition the union, each with the views that cover it; the plan's
    grid, shared memory and loads stay within the card's limits."""
    n, d, cap, block_n = 4096, 54, 2048, 64
    rng = np.random.default_rng(k)
    sb, widths = _mv_windows(kind, k, n, cap, block_n, rng)
    lo = [s * block_n for s in sb]
    hi = [a + w for a, w in zip(lo, widths)]
    want = np.zeros((k, n), np.int64)
    for v in range(k):
        want[v, lo[v]:hi[v]] = 1
    segs = multiview_segments(lo, hi)
    rows, masks = [], []
    for i, (a, m, mask) in enumerate(segs):
        assert m > 0 and mask
        if i:                                   # in row order, disjoint
            assert a >= segs[i - 1][0] + segs[i - 1][1]
        cover = [v for v in range(k) if mask >> v & 1]
        assert want[cover, a:a + m].all()        # its views cover it ...
        others = [v for v in range(k) if not mask >> v & 1]
        assert not want[others, a:a + m].any()   # ... and no other does
        rows += range(a, a + m)
        masks += [mask] * m
    assert sorted(rows) == list(np.flatnonzero(want.any(0)))   # the union
    p = multiview_plan(k, d, cap)
    total = len(rows)
    loops = -(-total // (p.grid * p.rows_per_block))
    got = np.zeros((k, n), np.int64)
    for u in range(loops * p.grid * p.rows_per_block):   # l, g, r in order
        if u < total:
            for v in range(k):
                got[v, rows[u]] += masks[u] >> v & 1
    assert np.array_equal(got, want)
    resident = min(MV_RESIDENT, SM_SMEM // (p.smem_bytes + BLOCK_SMEM_RESERVED))
    assert 1 <= p.grid <= SMS * resident
    assert p.grid <= max(1, -(-k * cap // p.rows_per_block))
    assert p.smem_bytes <= MAX_SMEM and resident >= 1
    assert p.smem_bytes >= 4 * k * d + 8 * (2 * k - 1) + 4 * 2 * k
    assert p.rows_per_block * p.lanes == MV_THREADS
    assert p.lanes & (p.lanes - 1) == 0 and p.loads_per_lane <= MAX_LOADS
    chunks = d * 4 // p.chunk_bytes
    assert p.lanes * p.loads_per_lane * p.passes >= chunks
    assert (d * 4) % p.chunk_bytes == 0
    assert p.chunk_bytes == 8           # 216-byte rows: 27 loads of 8 bytes


def test_multiview_plan_refuses_past_its_limits():
    with pytest.raises(ValueError, match="1 to 64 views"):
        multiview_plan(65, 54, 1024)
    with pytest.raises(ValueError, match="1 to 64 views"):
        multiview_plan(0, 54, 1024)
    with pytest.raises(ValueError, match="shared memory"):
        multiview_plan(7, 8300, 1024)
    assert multiview_plan(7, 8000, 1024).grid == SMS   # one block an SM
    assert multiview_plan(64, 54, 291_008).grid == SMS * MV_RESIDENT
    p = multiview_plan(7, 54, 291_008, address=4)       # F[1:] of a table
    assert (p.chunk_bytes, p.lanes, p.loads_per_lane) == (4, 8, 7)


def _ties_only(got, want, F, W, b):
    """Labels differ only where the float64 margin is within fp32
    rounding of the dot: |w·f − b| ≤ 1e-6·(‖f‖‖w‖ + |b|)."""
    v, r = np.nonzero(got != want)
    f, w = F[r].astype(np.float64), W[v].astype(np.float64)
    z = (f * w).sum(1) - b[v]
    tol = 1e-6 * (np.linalg.norm(f, axis=1) * np.linalg.norm(w, axis=1)
                  + np.abs(b[v]))
    return bool((np.abs(z) <= tol).all())


@pytest.mark.parametrize("k,n,d,kind", [
    (4, 2048, 64, "sweep"), (7, 2048, 128, "sweep"), (16, 4096, 32, "sweep"),
    (7, 2048, 54, "nested"), (7, 2048, 54, "identical")])
def test_multiview_planned_form_equals_pallas(k, n, d, kind):
    """The plain form that walks the multi-view kernel's plan (the union
    of the windows once, each row dotted in its lanes' order with every
    view covering it), behind the tile-aligned window arithmetic, against
    the Pallas kernel in interpret mode: tests/test_kernels.py's shapes and
    windows, and nested and identical windows; labels equal but for
    proven fp32 ties."""
    F, labels, W, b, r = _inputs(k, n, d, 10 + k)
    cap, block_n = 2048, 256
    if kind == "sweep":
        starts = r.integers(0, n, k).astype(np.int32)
        ends = np.minimum(starts + r.integers(0, 1500, k), n)
    elif kind == "nested":
        starts = np.zeros(k, np.int32)
        ends = (np.arange(1, k + 1) * 290).astype(np.int32)
    else:
        starts = np.full(k, 300, np.int32)
        ends = np.full(k, 1700, np.int32)
    ends = ends.astype(np.int32)
    sb = np.clip(starts // block_n, 0, (n - cap) // block_n).astype(np.int32)
    widths = np.clip(ends - sb * block_n, 0, cap).astype(np.int32)
    got = multiview_band_reclassify_planned_ref(
        torch.tensor(F), torch.tensor(labels), torch.tensor(W),
        torch.tensor(b), torch.tensor(sb), torch.tensor(widths),
        block_n=block_n, plan=multiview_plan(k, d, cap)).numpy()
    want = np.asarray(_jax(F, labels, W, b, starts, ends, cap=cap,
                           block_n=block_n))
    assert _ties_only(got, want, F, W, b)
    assert not np.array_equal(got, labels)      # windows were relabeled
    direct = multiview_band_reclassify_ref(
        torch.tensor(F), torch.tensor(labels), torch.tensor(W),
        torch.tensor(b), torch.tensor(sb), torch.tensor(widths), cap=cap,
        block_n=block_n).numpy()
    assert _ties_only(got, direct, F, W, b)
