"""The port's runtime lock-order witness (`repro_torch.analysis.witness`)
does what the reference's witness cases in tests/test_analysis.py show:
under `REPRO_LOCK_WITNESS=1` an inverted acquisition order raises
`LockOrderError`, the pool lock is reentrant and the gate is not, and an
`EntityStore` cold read under the pool lock raises, while the pool's own
protocol (every read off its lock) runs clean, also under 8 threads.
With the variable unset it does nothing: `wrap` hands back the raw
lock."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import witness as RW                    # noqa: E402

from repro_torch.analysis import witness as W               # noqa: E402
from repro_torch.storage import BufferPool, EntityStore     # noqa: E402

JOIN_S = 60


@pytest.fixture
def armed(monkeypatch):
    """The witness as a process started with REPRO_LOCK_WITNESS=1 has it."""
    monkeypatch.setenv("REPRO_LOCK_WITNESS", "1")
    monkeypatch.setattr(W, "WITNESS", W._Witness())
    assert W.WITNESS.active
    return W.WITNESS


@pytest.fixture
def unarmed(monkeypatch):
    monkeypatch.delenv("REPRO_LOCK_WITNESS", raising=False)
    monkeypatch.setattr(W, "WITNESS", W._Witness())
    assert not W.WITNESS.active
    return W.WITNESS


def test_same_lock_ids_and_order_as_the_reference():
    assert W.LOCK_ORDER == RW.LOCK_ORDER
    assert W.REENTRANT == RW.REENTRANT
    assert issubclass(W.LockOrderError, AssertionError)


def test_only_the_value_1_arms_it(monkeypatch):
    for value, armed in (("1", True), ("0", False), ("yes", False)):
        monkeypatch.setenv("REPRO_LOCK_WITNESS", value)
        assert W._Witness().enabled is armed
    monkeypatch.delenv("REPRO_LOCK_WITNESS")
    assert W._Witness().enabled is False


def test_inverted_order_raises(armed):
    gate = W.wrap(threading.Lock(), "gate")
    wal = W.wrap(threading.RLock(), "wal_commit")
    pool = W.wrap(threading.RLock(), "pool")
    assert isinstance(pool, W.WitnessedLock)
    with gate, wal, pool:                    # the declared order, upward
        assert armed.held() == ["gate", "wal_commit", "pool"]
    with pool:
        with pytest.raises(W.LockOrderError, match="inversion"):
            with wal:
                pass                         # pragma: no cover
        assert armed.held() == ["pool"]      # the refused one not recorded
    assert armed.held() == []


def test_pool_is_reentrant_and_the_gate_is_not(armed):
    pool = W.wrap(threading.RLock(), "pool")
    with pool:
        with pool:
            assert armed.held() == ["pool", "pool"]
    gate = W.wrap(threading.Lock(), "gate")
    with gate:
        with pytest.raises(W.LockOrderError, match="reentrant"):
            gate.acquire()                   # reported, not deadlocked
    with pytest.raises(ValueError):
        W.wrap(threading.RLock(), "not-a-lock")


def test_store_read_under_the_pool_lock_raises(armed):
    F = np.arange(32, dtype=np.float32).reshape(8, 4)
    store = EntityStore.from_array(F, page_bytes=64)
    pool = BufferPool(store, 64)
    assert isinstance(pool._lock, W.WitnessedLock)   # built while armed
    with pool._lock:
        with pytest.raises(W.LockOrderError, match="read_page"):
            store.read_page(0)
        with pytest.raises(W.LockOrderError, match="read_pages"):
            store.read_pages([0, 1])
    # the pool's own paths read off the lock: a miss, pins, warming
    assert pool.get_row(5).numpy().tobytes() == F[5].tobytes()
    pool.repin_rows([0, 1])
    pool.warm(range(8))
    assert store.read_page(0).shape[0] > 0
    store.close()


def test_pool_under_threads_never_reads_under_its_lock(armed):
    F = np.random.default_rng(0).normal(size=(128, 8)).astype(np.float32)
    store = EntityStore.from_array(F, page_bytes=128)
    pool = BufferPool(store, 4 * store.page_bytes)
    errors = []

    def probe(t):
        rng = np.random.default_rng(t)
        try:
            for i in rng.integers(0, 128, 200):
                assert pool.get_row(int(i)).numpy().tobytes() == \
                    F[i].tobytes()
            assert armed.held() == []
        except Exception as e:               # noqa: BLE001 — surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=probe, args=(t,), daemon=True)
               for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert pool.hits + pool.misses + pool.coalesced == pool.probes == 1600
    store.close()


def test_unset_it_does_nothing(unarmed):
    lock = threading.RLock()
    assert W.wrap(lock, "pool") is lock
    F = np.ones((8, 4), np.float32)
    store = EntityStore.from_array(F, page_bytes=64)
    pool = BufferPool(store, 64)
    assert not isinstance(pool._lock, W.WitnessedLock)
    with pool._lock:
        assert store.read_page(0).shape[0] > 0   # no witness, no check
    W.assert_unlocked("pool", "anything")
    with W.enabled():                        # a scope can still force it
        assert isinstance(W.wrap(threading.RLock(), "pool"),
                          W.WitnessedLock)
    assert not W.WITNESS.active
    store.close()
