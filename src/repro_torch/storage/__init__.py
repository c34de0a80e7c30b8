"""Memory-budgeted storage tier behind the §3.5.2 hybrid probe, the
counterpart of `repro.storage` (the paper's third contribution: only a
fraction of the entities in memory).

  * `EntityStore` (store.py) — the on-disk entity table: float32 rows in
    one memory-mapped file (the reference's format), split into pages,
    with a page directory keyed by entity id; reading a page is the unit
    of "disk" I/O;
  * `BufferPool` (pool.py) — a byte budget over those pages: clock
    eviction, pins (the hot buffers are pinned pool pages), warming along
    the eps order, per-tier counters; cold reads run off the pool lock
    behind per-page latches;
  * `Prefetcher` (prefetch.py) — a background readahead worker fed by the
    engines.

`HazyEngine`, `MultiViewEngine`, `MulticlassView` (vectorized) and
`ClassificationView` take `store=BufferPool(...)`: a probe the waters
cannot resolve reads its row through the pool (tier "pool" when the page
was resident, "disk" for a cold read) and is classified on the host.
"""
from repro_torch.storage.pool import BufferPool
from repro_torch.storage.prefetch import Prefetcher
from repro_torch.storage.store import PAGE_BYTES, EntityStore

__all__ = ["BufferPool", "EntityStore", "PAGE_BYTES", "Prefetcher"]
