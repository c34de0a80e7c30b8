"""The port's storage tier (`repro_torch.storage`: `EntityStore`,
`BufferPool`, `Prefetcher`) and the engines over it, against the
reference's (`repro.storage`), on the CPU: the cases of
tests/test_storage.py.

  * Pool-only cases: the reference pool and the port's pool are driven
    with the same single-threaded call sequence over the same rows; the
    bytes they return are identical, and so are `stats()` (key for key),
    the resident pages, the clock and the pins. A store written by the
    reference opens in the port and reads the same pages.
  * Threaded cases (8 threads): run on the port and held to the
    invariants the reference's tests assert, not to its counts (thread
    timing differs); every join and wait has a timeout.
  * Engine-over-pool cases: the port's `HazyEngine`, `MulticlassView`
    and `ClassificationView` (device="cpu", the kernels' plain versions)
    over a pool, each also held to the reference engine over its own
    pool on the same stream: labels, `hybrid_hits`, `disk_touches` and
    the pool's `stats()` equal."""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R                                      # noqa: E402
import repro.storage as RS                                  # noqa: E402
from repro.core.facade import MultiViewFacade as RMVF       # noqa: E402
from repro.core.facade import SingleViewFacade as RSVF      # noqa: E402
from repro.core.linear_model import sgd_step, zero_model    # noqa: E402
from repro.data import (cora_like, multiclass_example_stream,  # noqa: E402
                        synthetic_corpus)

import repro_torch.core as T                                # noqa: E402
import repro_torch.storage as TS                            # noqa: E402
from repro_torch.core.engine import TIER_DISK, TIER_POOL    # noqa: E402
from repro_torch.core.facade import MultiViewFacade as TMVF  # noqa: E402
from repro_torch.core.facade import SingleViewFacade as TSVF  # noqa: E402

CPU = dict(device="cpu")
JOIN_S = 60          # every join and wait below is bounded


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny CPU products: torch's threads only cost here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(n=96, d=16, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _pools(F, frac, page_bytes=512):
    """(reference pool, port pool) over the same rows, same geometry."""
    out = []
    for pkg in (RS, TS):
        store = pkg.EntityStore.from_array(F, page_bytes=page_bytes)
        out.append(pkg.BufferPool(store, max(1, int(frac * F.nbytes))))
    return out


def _raw(row):
    """The bytes of a row from either package."""
    return (row.numpy() if isinstance(row, torch.Tensor) else row).tobytes()


def _both(pools, method, *args, **kw):
    """The same call on both pools; the rows it returns byte-identical."""
    ref, port = (getattr(p, method)(*args, **kw) for p in pools)
    if method in ("get_row", "touch"):
        r, t = (ref, port) if method == "get_row" else (ref[0], port[0])
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        assert _raw(t) == _raw(r)
        if method == "touch":
            assert ref[1] == port[1]
    return ref, port


def assert_same_pool(ref, port):
    """Counters, residency, clock, pins and resident bytes identical."""
    assert port.stats() == ref.stats()
    assert list(port.frames) == list(ref.frames)
    assert port._clock == ref._clock and port._hand == ref._hand
    assert list(port._hot_pins) == list(ref._hot_pins)
    assert port.store.page_reads == ref.store.page_reads
    for pid, fr in ref.frames.items():
        pf = port.frames[pid]
        assert (pf.pin_count, pf.ref, pf.readahead, pf.nbytes) == (
            fr.pin_count, fr.ref, fr.readahead, fr.nbytes), pid
        assert _raw(pf.data) == _raw(fr.data), pid


# ---------------------------------------------------------------------------
# EntityStore: the mapped rows and the page directory are exact
# ---------------------------------------------------------------------------

def test_store_roundtrip_is_byte_exact():
    F = _features()
    ref, port = (pkg.EntityStore.from_array(F, page_bytes=256)
                 for pkg in (RS, TS))
    assert port.num_pages == ref.num_pages == -(-port.n // port.rows_per_page)
    assert np.array_equal(port.dir_page, ref.dir_page)
    assert np.array_equal(port.dir_slot, ref.dir_slot)
    for i in range(F.shape[0]):
        pid, slot = port.page_of(i), port.slot_of(i)
        assert (pid, slot) == (ref.page_of(i), ref.slot_of(i))
        page = port.read_page(pid)
        assert isinstance(page, torch.Tensor) and page.device.type == "cpu"
        assert _raw(page[slot]) == F[i].tobytes() == _raw(
            ref.read_page(pid)[slot]), i
    assert port.page_reads == ref.page_reads == F.shape[0]
    path = port.path
    port.close()
    with pytest.raises(ValueError):
        port.read_page(0)
    import os
    assert not os.path.exists(path)          # the private file is removed
    ref.close()


def test_store_pages_share_no_memory_with_the_file():
    F = _features(n=32, d=8, seed=1)
    store = TS.EntityStore.from_array(F, page_bytes=64)
    page = store.read_page(0)
    page += 1.0                              # a private copy: file intact
    assert _raw(store.read_page(0)) == F[:store.rows_per_page].tobytes()
    store.close()


def test_store_written_by_the_reference_opens_in_the_port():
    F = _features(n=200, d=13, seed=2)
    ref = RS.EntityStore.from_array(F, page_bytes=256)
    port = TS.EntityStore(ref.path, ref.n, ref.d, ref.rows_per_page)
    assert (port.page_bytes, port.num_pages) == (ref.page_bytes,
                                                 ref.num_pages)
    for pid in range(ref.num_pages):
        assert _raw(port.read_page(pid)) == _raw(ref.read_page(pid)), pid
    pids = [3, 4, 5, 0, 9, 8]
    for got, want in zip(port.read_pages(pids), ref.read_pages(pids)):
        assert _raw(got) == _raw(want)
    port.close()                             # does not own the file
    assert _raw(ref.read_page(1)) == F[ref.rows_per_page:
                                       2 * ref.rows_per_page].tobytes()
    ref.close()


def test_store_wide_rows_get_one_row_pages():
    F = _features(n=8, d=200)                # stride 800 B > 256 B page
    pools = []
    for pkg in (RS, TS):
        store = pkg.EntityStore.from_array(F, page_bytes=256)
        assert store.rows_per_page == 1 and store.num_pages == 8
        pools.append(pkg.BufferPool(store, store.page_bytes))  # ONE page
    for i in range(8):
        _both(pools, "get_row", i)
    assert len(pools[1].frames) == 1 and pools[1].evictions == 7
    assert_same_pool(*pools)


# ---------------------------------------------------------------------------
# BufferPool: budget, eviction, pins, warming, counters
# ---------------------------------------------------------------------------

def test_eviction_never_drops_pinned_page():
    F = _features()
    pools = _pools(F, 0.10)
    port = pools[1]
    budget_pages = port.budget_bytes // port.store.page_bytes
    _both(pools, "repin_rows", [0, 1, 2])
    pinned = set(port._hot_pins)
    assert pinned
    for i in range(F.shape[0]):
        _both(pools, "get_row", i)
        assert pinned <= set(port.frames), i
        for pid in pinned:
            assert port.frames[pid].pin_count > 0
    assert port.evictions > 0
    assert len(port.frames) <= budget_pages + 1
    assert_same_pool(*pools)
    _both(pools, "repin_rows", [])
    for i in range(F.shape[0]):
        _both(pools, "get_row", i)
    assert all(fr.pin_count == 0 for fr in port.frames.values())
    assert_same_pool(*pools)


def test_repin_keeps_the_full_window_across_reorgs():
    F = _features()
    pools = _pools(F, 0.30)
    _both(pools, "repin_rows", range(0, 24))
    first = list(pools[1]._hot_pins)
    assert len(first) > 1
    for _ in range(3):                       # reorgs with an identical window
        _both(pools, "repin_rows", range(0, 24))
        assert list(pools[1]._hot_pins) == first
    assert_same_pool(*pools)
    # engine-level: the hot window stays fully pinned through reorgs
    c = cora_like(scale=0.15)
    epools = _pools(c.features, 0.10, page_bytes=1024)
    opts = dict(p=2.0, q=2.0, policy="hybrid", buffer_frac=0.03)
    engines = [R.HazyEngine(c.features, store=epools[0], **opts),
               T.HazyEngine(c.features, store=epools[1], **opts, **CPU)]
    pinned_after_init = len(epools[1]._hot_pins)
    for eng in engines:
        eng.reorganize()
        eng.reorganize()
    assert len(epools[1]._hot_pins) == pinned_after_init > 0
    assert_same_pool(*epools)


def test_pins_alone_never_exceed_budget():
    F = _features()
    pools = _pools(F, 0.10)
    _both(pools, "repin_rows", range(F.shape[0]))   # ask to pin EVERYTHING
    port = pools[1]
    assert port.pinned_bytes() <= port.budget_bytes
    assert len(port._hot_pins) >= 1
    assert_same_pool(*pools)


def test_get_row_after_eviction_rereads_identical_bytes():
    F = _features()
    pools = _pools(F, 0.08)
    port = pools[1]
    first = _raw(_both(pools, "get_row", 0)[1])
    assert port.misses == 1
    evicted_reads = port.store.page_reads
    for i in range(F.shape[0] - 1, port.store.rows_per_page, -1):
        _both(pools, "get_row", i)
    assert not port.resident(0)
    again = _raw(_both(pools, "get_row", 0)[1])
    assert again == first == F[0].tobytes()
    assert port.store.page_reads > evicted_reads
    assert_same_pool(*pools)


def test_counters_reconcile_and_warm_is_not_a_miss():
    F = _features()
    pools = _pools(F, 0.25)
    port = pools[1]
    _both(pools, "warm", range(F.shape[0]))
    assert port.misses == 0 and port.prefetches > 0
    assert port.resident_bytes <= port.budget_bytes
    assert_same_pool(*pools)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, F.shape[0], 200)
    for i in ids:
        _both(pools, "get_row", int(i))
    assert port.hits + port.misses == port.probes == ids.size
    st = port.stats()
    assert st["hits"] == port.hits and st["misses"] == port.misses
    assert 0.0 <= st["hit_rate"] <= 1.0
    assert_same_pool(*pools)


def test_full_budget_pool_never_cold_misses_after_warm():
    F = _features()
    pools = _pools(F, 1.0)
    _both(pools, "warm", range(F.shape[0]))
    for i in range(F.shape[0]):
        _, (_, how) = _both(pools, "touch", i)
        assert how == "pool", i
    assert pools[1].misses == 0 and pools[1].evictions == 0
    assert_same_pool(*pools)


def test_read_pages_batches_are_byte_exact():
    F = _features(n=96, d=16, seed=23)
    ref, port = (pkg.EntityStore.from_array(F, page_bytes=256)
                 for pkg in (RS, TS))
    assert port.num_pages >= 8
    pids = [0, 1, 2, 5, 7, 3, 4]             # contiguous runs + scatter
    before = port.page_reads
    pages = port.read_pages(pids)
    assert port.page_reads - before == len(pids)
    for pid, page, want in zip(pids, pages, ref.read_pages(pids)):
        assert _raw(page) == _raw(port.read_page(pid)) == _raw(want), pid


def test_prefetch_pages_streams_and_sweeps_like_the_reference():
    """The batched readahead path, single-threaded: streaming (evict)
    and warm schedules leave identical pools."""
    F = _features(n=256, d=16, seed=24)
    pools = _pools(F, 0.20)
    _both(pools, "repin_rows", range(8))
    for evict, batch in ((True, 4), (False, 64), (True, 3)):
        got = _both(pools, "_prefetch_pages", np.arange(0, 60),
                    evict=evict, readahead=True, batch=batch)
        assert got[0] == got[1]
        assert_same_pool(*pools)
    for i in range(0, 256, 5):
        _both(pools, "get_row", i)
    assert pools[1].readahead_used > 0
    assert_same_pool(*pools)


# ---------------------------------------------------------------------------
# BufferPool under threads: the invariants, on the port
# ---------------------------------------------------------------------------

def _run_threads(target, n_threads):
    threads = [threading.Thread(target=target, args=(t,), daemon=True)
               for t in range(n_threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)              # interleave as much as we can
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)


def test_pool_concurrent_probes_never_corrupt_or_evict_pins():
    """8 threads hammer ONE tiny-budget pool against a pinned hot window:
    every row byte-exact, no pinned page ever leaves the pool, and the
    counters reconcile exactly with the probes issued."""
    F = _features(n=256, d=16, seed=9)
    pool = _pools(F, 0.08)[1]
    pool.repin_rows(range(8))
    pinned = set(pool._hot_pins)
    assert pinned
    probes0 = pool.probes
    per_thread, n_threads = 400, 8
    errors = []

    def hammer(t):
        rng = np.random.default_rng(100 + t)
        try:
            for _ in range(per_thread):
                i = int(rng.integers(0, F.shape[0]))
                if _raw(pool.get_row(i)) != F[i].tobytes():
                    errors.append(f"row {i} corrupt")
                    return
                if not pinned <= set(pool.frames):
                    errors.append("pinned page evicted")
                    return
        except Exception as e:               # noqa: BLE001 — surfaced below
            errors.append(repr(e))

    _run_threads(hammer, n_threads)
    assert not errors, errors[:3]
    assert pool.hits + pool.misses + pool.coalesced == pool.probes
    assert pool.probes - probes0 == per_thread * n_threads
    for pid in pinned:
        assert pool.frames[pid].pin_count > 0
    assert pool.in_flight == 0
    assert pool.resident_bytes <= pool.budget_bytes + pool.store.page_bytes
    st = pool.stats()
    assert st["hits"] + st["misses"] + st["coalesced"] == st["probes"]
    assert pool.store.page_reads <= pool.misses + pool.prefetches


def test_cold_miss_storm_coalesces_to_one_disk_read():
    """8 threads cold-miss ONE page at once: exactly one `read_page`, one
    miss, 7 coalesced waiters, and byte-exact rows for every thread."""
    F = _features(n=64, d=16, seed=21)
    store = TS.EntityStore.from_array(F, page_bytes=512)
    pool = TS.BufferPool(store, F.nbytes)
    rows = store.page_row_ids(0)
    n_threads = 8
    start = threading.Barrier(n_threads, timeout=JOIN_S)
    results, errors = [], []
    inner = store.read_page

    def gated_read(pid):                     # hold the one cold read open
        deadline = 200                       # until every waiter has parked
        while pool.coalesced < n_threads - 1 and deadline:
            threading.Event().wait(0.01)
            deadline -= 1
        return inner(pid)

    store.read_page = gated_read

    def storm(t):
        i = int(rows[t % len(rows)])
        try:
            start.wait()
            row, how = pool.touch(i)
            results.append((i, _raw(row), how))
        except Exception as e:               # noqa: BLE001 — surfaced below
            errors.append(repr(e))

    _run_threads(storm, n_threads)
    assert not errors, errors[:3]
    assert len(results) == n_threads
    assert store.page_reads == 1             # THE coalescing guarantee
    assert pool.misses == 1
    assert pool.coalesced == n_threads - 1
    assert pool.hits == 0 and pool.in_flight == 0
    for i, raw, how in results:
        assert raw == F[i].tobytes(), i
        assert how == "disk"                 # miss AND waiters: cold tier


def test_eviction_never_reclaims_in_flight_frames():
    """The clock sweep skips placeholder (data=None) frames: an in-flight
    page under budget pressure survives until its loader publishes."""
    F = _features(n=64, d=16, seed=22)
    store = TS.EntityStore.from_array(F, page_bytes=512)
    pool = TS.BufferPool(store, store.page_bytes)    # budget: ONE page
    gate = threading.Event()
    inner = store.read_page

    def slow_read(pid):
        gate.wait(JOIN_S)                    # hold page 0's read open
        return inner(pid)

    store.read_page = slow_read
    t = threading.Thread(target=lambda: pool.get_row(0), daemon=True)
    t.start()
    installed = threading.Event()
    for _ in range(JOIN_S * 100):            # loader installed, now blocked
        if pool.in_flight:
            installed.set()
            break
        installed.wait(0.01)
    assert installed.is_set()
    store.read_page = inner                  # other pages read normally
    pool.get_row(int(store.page_row_ids(1)[0]))      # forces a sweep
    with pool._lock:
        assert 0 in pool.frames              # placeholder NOT evicted
        assert pool.frames[0].data is None
    gate.set()
    t.join(JOIN_S)
    assert not t.is_alive()
    assert _raw(pool.get_row(0)) == F[0].tobytes()
    assert pool.in_flight == 0


def test_failed_cold_read_reaches_every_waiter_and_drops_the_frame():
    """A read that raises removes its placeholder, un-charges the budget
    and re-raises in the loader; the next probe reads again."""
    F = _features(n=64, d=16, seed=26)
    store = TS.EntityStore.from_array(F, page_bytes=512)
    pool = TS.BufferPool(store, F.nbytes)
    inner = store.read_page

    def broken(pid):
        raise OSError("disk gone")

    store.read_page = broken
    with pytest.raises(OSError, match="disk gone"):
        pool.get_row(0)
    assert 0 not in pool.frames and pool.resident_bytes == 0
    assert pool.in_flight == 0
    store.read_page = inner
    assert _raw(pool.get_row(0)) == F[0].tobytes()
    assert pool.misses == 2


def test_prefetcher_readahead_counters_and_clean_shutdown():
    F = _features(n=256, d=16, seed=24)
    pool = _pools(F, 0.50)[1]
    pre = TS.Prefetcher(pool, batch_pages=4)
    assert pool.prefetcher is pre and pre.alive
    pre.enqueue(range(64), evict=True)       # streaming readahead
    assert pre.drain(JOIN_S)
    assert pool.readahead_pages > 0
    used0 = pool.readahead_used
    pool.get_row(0)                          # consume a readahead page
    assert pool.readahead_used == used0 + 1
    assert pool.hits >= 1
    st = pool.stats()
    assert 0.0 <= st["readahead_hit_rate"] <= 1.0
    assert st["readahead_pages"] == pool.readahead_pages
    assert pre.stats() == {"enqueued": 1, "dropped": 0, "errors": 0,
                           "queued": 0, "alive": True}
    pre.close(JOIN_S)
    assert not pre.alive                     # no dangling thread
    assert pool.prefetcher is None
    pre.close(JOIN_S)                        # idempotent
    pre.enqueue(range(8))                    # closed: ignored
    assert pre.stats()["enqueued"] == 1


def test_prefetcher_warm_mode_respects_budget_and_pins():
    F = _features(n=256, d=16, seed=25)
    pool = _pools(F, 0.10)[1]
    pool.repin_rows(range(8))
    pinned = set(pool._hot_pins)
    pre = TS.Prefetcher(pool)
    try:
        pre.enqueue(range(F.shape[0]))       # warm semantics: stop at budget
        assert pre.drain(JOIN_S)
        assert pool.resident_bytes <= pool.budget_bytes
        assert pinned <= set(pool.frames)
        for pid in pinned:
            assert pool.frames[pid].pin_count > 0
        pre.enqueue(range(F.shape[0]), evict=True)
        assert pre.drain(JOIN_S)
        assert pinned <= set(pool.frames)
        assert (pool.resident_bytes
                <= pool.budget_bytes + pre.batch_pages * pool.store.page_bytes)
    finally:
        pre.close(JOIN_S)
    assert not pre.alive


# ---------------------------------------------------------------------------
# Engines over the pool: exactness, pinned hot buffers, tier accounting,
# each also held to the reference engine over its own pool
# ---------------------------------------------------------------------------

def _drive_multiclass(mod, c, policy, store=None, rounds=15, batch=16,
                      **kw):
    view = mod.MulticlassView(c.features, c.num_classes, policy=policy,
                              buffer_frac=0.05, p=2.0, q=2.0, lr=0.1,
                              cost_mode="modeled", store=store, **kw)
    stream = multiclass_example_stream(c, seed=13)
    for _ in range(rounds):
        chunk = [next(stream) for _ in range(batch)]
        view.insert_examples([i for i, _ in chunk], [cl for _, cl in chunk])
    return view


def _multiclass_pair(c, frac, policy="hybrid"):
    pools = _pools(c.features, frac, page_bytes=1024)
    ref = _drive_multiclass(R, c, policy, store=pools[0])
    port = _drive_multiclass(T, c, policy, store=pools[1], **CPU)
    return pools, ref, port


def test_hybrid_labels_under_5pct_budget_equal_eager_all_in_ram():
    c = cora_like(scale=0.15)
    pools, ref, hyb = _multiclass_pair(c, 0.05)
    eag = _drive_multiclass(T, c, "eager", **CPU)    # all-in-RAM twin
    assert np.array_equal(hyb.W, eag.W) and np.array_equal(hyb.b, eag.b)
    assert np.array_equal(hyb.W, ref.W) and np.array_equal(hyb.b, ref.b)
    assert hyb.engine.buffer_F is None
    for i in range(c.features.shape[0]):
        labs, hows = hyb.engine.hybrid_labels_of(i)
        r_labs, r_hows = ref.engine.hybrid_labels_of(i)
        assert np.array_equal(labs, eag.engine.labels_of(i)), i
        assert np.array_equal(labs, r_labs) and np.array_equal(hows, r_hows)
    # the cold fraction was really bounded by the budgeted pool, not RAM
    assert hyb.engine.disk_touches == pools[1].misses
    assert hyb.engine.disk_touches == ref.engine.disk_touches
    assert np.array_equal(hyb.engine.hybrid_hits, ref.engine.hybrid_hits)
    assert hyb.engine.hybrid_hits[TIER_POOL] > 0
    assert_same_pool(*pools)
    assert hyb.engine.check_consistent()


def test_multiview_tier_counts_reconcile_with_pool():
    c = cora_like(scale=0.15)
    pools, ref, view = _multiclass_pair(c, 0.10)
    pool = pools[1]
    eng = view.engine
    h0, p0 = eng.hybrid_hits.copy(), pool.stats()
    rng = np.random.default_rng(7)
    reads = 150
    for i in rng.integers(0, c.features.shape[0], reads):
        v = int(rng.integers(0, c.num_classes))
        assert eng.hybrid_label(v, int(i)) == ref.engine.hybrid_label(
            v, int(i))
    dh = eng.hybrid_hits - h0
    assert dh.sum() == reads                 # every probe landed in one tier
    p1 = pool.stats()
    assert (p1["probes"] - p0["probes"]) == dh[1] + dh[TIER_POOL] + dh[TIER_DISK]
    assert (p1["misses"] - p0["misses"]) == dh[TIER_DISK]
    assert (p1["hits"] - p0["hits"]) == dh[1] + dh[TIER_POOL]
    assert np.array_equal(eng.hybrid_hits, ref.engine.hybrid_hits)
    assert eng.disk_touches == ref.engine.disk_touches == pool.misses
    assert_same_pool(*pools)


def test_hot_buffer_reads_are_pinned_pool_hits():
    c = cora_like(scale=0.15)
    pools, ref, view = _multiclass_pair(c, 0.10)
    pool = pools[1]
    eng = view.engine
    assert eng.buffer_F is None              # no separately materialized copy
    probed = 0
    for v in range(eng.k):
        lo, hi = int(eng.buffer_lo[v]), int(eng.buffer_hi[v])
        for pos in range(lo, hi, 3):
            i = int(eng.perm[v, pos])
            misses_before = pool.misses
            lab, how = eng.hybrid_label(v, i)
            assert (lab, how) == ref.engine.hybrid_label(v, i)
            if how == "buffer":
                probed += 1
                assert pool.misses == misses_before, (v, i)
    assert probed > 0
    assert_same_pool(*pools)


def test_hazy_store_probe_exact_and_cold_counting():
    c = synthetic_corpus("hzst", 400, 24, seed=2)
    pools = _pools(c.features, 0.10, page_bytes=1024)
    opts = dict(p=2.0, q=2.0, policy="hybrid", buffer_frac=0.05)
    ref = R.HazyEngine(c.features, store=pools[0], **opts)
    eng = T.HazyEngine(c.features, store=pools[1], **opts, **CPU)
    model = zero_model(c.features.shape[1])
    rng = np.random.default_rng(11)
    for _t in range(200):
        i = int(rng.integers(0, c.features.shape[0]))
        model = sgd_step(model, c.features[i], float(c.labels[i]),
                         lr=0.05, l2=1e-3)
        ref.apply_model(model)
        eng.apply_model(model)
    truth = np.where(c.features @ model.w - model.b >= 0, 1, -1)
    tiers = {"water": 0, "buffer": 0, "pool": 0, "disk": 0}
    for i in range(c.features.shape[0]):
        lab, how = eng.hybrid_label(i)
        assert lab == truth[i], (i, how)
        assert (lab, how) == ref.hybrid_label(i)
        tiers[how] += 1
    assert sum(tiers.values()) == c.features.shape[0]
    assert tiers["pool"] + tiers["disk"] > 0
    assert eng.disk_touches == pools[1].misses == ref.disk_touches
    assert eng.stats.reorgs == ref.stats.reorgs
    assert_same_pool(*pools)


def test_hazy_store_readahead_through_a_prefetcher():
    """A cold probe hands the next boundary-outward entities to the
    prefetcher (`_hint_readahead`); the rows it loads serve later probes
    as pool hits, and the labels stay exact."""
    c = synthetic_corpus("hzra", 600, 24, seed=4)
    store = TS.EntityStore.from_array(c.features, page_bytes=1024)
    pool = TS.BufferPool(store, int(0.10 * c.features.nbytes))
    pre = TS.Prefetcher(pool, batch_pages=2)
    try:
        eng = T.HazyEngine(c.features, p=2.0, q=2.0, policy="hybrid",
                           buffer_frac=0.02, store=pool, **CPU)
        model = zero_model(c.features.shape[1])
        rng = np.random.default_rng(12)
        for _t in range(120):
            i = int(rng.integers(0, c.features.shape[0]))
            model = sgd_step(model, c.features[i], float(c.labels[i]),
                             lr=0.05, l2=1e-3)
            eng.apply_model(model)
        assert pre.drain(JOIN_S)
        truth = np.where(c.features @ model.w - model.b >= 0, 1, -1)
        for i in rng.permutation(c.features.shape[0]):
            assert eng.hybrid_label(int(i))[0] == truth[i]
        assert pre.drain(JOIN_S)
        assert pool.readahead_pages > 0 and pre.stats()["errors"] == 0
        assert eng.disk_touches == pool.misses
        assert pool.hits + pool.misses + pool.coalesced == pool.probes
    finally:
        pre.close(JOIN_S)
    assert not pre.alive


def test_refresh_features_does_not_close_a_shared_store():
    """Two budgeted views share ONE EntityStore (the catalog layout);
    refreshing one view must not brick its sibling."""
    F1 = _features(n=128, d=16, seed=5)
    F2 = _features(n=128, d=16, seed=6)
    store = TS.EntityStore.from_array(F1, page_bytes=512)
    pool_a = TS.BufferPool(store, 2048)
    pool_b = TS.BufferPool(store, 2048)
    opts = dict(policy="hybrid", norm=(2.0, 2.0), buffer_frac=0.05, **CPU)
    va = T.ClassificationView(F1, store=pool_a, **opts)
    vb = T.ClassificationView(F1, store=pool_b, **opts)
    va.refresh_features(entities=F2)
    assert _raw(pool_b.get_row(3)) == F1[3].tobytes()
    new_pool = va.engine.store
    assert new_pool is not pool_a and new_pool.store is not store
    assert new_pool.store.page_bytes == store.page_bytes
    assert new_pool.budget_bytes == pool_a.budget_bytes
    assert _raw(new_pool.get_row(3)) == F2[3].tobytes()
    assert vb.engine.store is pool_b
    assert not pool_a.frames                 # the old pool was closed
    # and as the reference does it, over the same stream
    rstore = RS.EntityStore.from_array(F1, page_bytes=512)
    rva = R.ClassificationView(F1, store=RS.BufferPool(rstore, 2048),
                               policy="hybrid", norm=(2.0, 2.0),
                               buffer_frac=0.05)
    rva.refresh_features(entities=F2)
    rva.engine.store.get_row(3)              # the probe made on va's above
    rng = np.random.default_rng(8)
    for _ in range(4):
        ids = rng.integers(0, 128, 8).tolist()
        ys = np.where(F2[ids, 0] > 0, 1.0, -1.0).tolist()
        for view in (va, rva):
            view.insert_examples(ids, ys)
    assert np.array_equal(va.model.w, rva.model.w)
    for i in range(128):
        assert va.label(i) == rva.label(i), i
    assert va.engine.disk_touches == rva.engine.disk_touches
    assert_same_pool(rva.engine.store, va.engine.store)


def test_facades_report_the_pool_and_prefetch_the_band():
    """`storage_stats` answers from the pool, `prefetcher_stats` from its
    prefetcher, and `prefetch_band` schedules the prospective band —
    as the reference facades do."""
    c = cora_like(scale=0.15)
    pools, ref, port = _multiclass_pair(c, 0.10)
    facs = [RMVF(ref), TMVF(port)]
    assert facs[1].storage_stats() == facs[0].storage_stats()
    assert facs[1].prefetch_band(0) == 0     # no prefetcher yet
    pres = [RS.Prefetcher(pools[0]), TS.Prefetcher(pools[1])]
    try:
        for v in range(c.num_classes):
            assert facs[1].prefetch_band(v) == facs[0].prefetch_band(v)
        assert pres[1].drain(JOIN_S) and pres[0].drain(JOIN_S)
        assert facs[1].prefetcher_stats() == facs[0].prefetcher_stats()
        snap = facs[1].telemetry_snapshot()
        assert snap["storage"] == pools[1].stats()
        assert snap["prefetcher"]["alive"]
        assert_same_pool(*pools)
    finally:
        for pre in pres:
            pre.close(JOIN_S)
    F = _features(n=160, d=12, seed=9)
    spools = _pools(F, 0.2, page_bytes=256)
    opts = dict(policy="hybrid", norm=(2.0, 2.0), buffer_frac=0.05,
                cost_mode="modeled")
    views = [R.ClassificationView(F, store=spools[0], **opts),
             T.ClassificationView(F, store=spools[1], **opts, **CPU)]
    rng = np.random.default_rng(10)
    for _ in range(5):                       # ends with a pending band
        ids = rng.integers(0, 160, 4).tolist()
        ys = np.where(F[ids, 1] > 0, 1.0, -1.0).tolist()
        for view in views:
            view.insert_examples(ids, ys)
    sfacs = [RSVF(views[0]), TSVF(views[1])]
    assert sfacs[1].storage_stats() == sfacs[0].storage_stats()
    spres = [RS.Prefetcher(spools[0]), TS.Prefetcher(spools[1])]
    try:
        assert sfacs[1].prefetch_band() == sfacs[0].prefetch_band() > 0
        assert spres[1].drain(JOIN_S) and spres[0].drain(JOIN_S)
        assert_same_pool(*spools)
    finally:
        for pre in spres:
            pre.close(JOIN_S)
