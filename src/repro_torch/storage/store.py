"""On-disk entity store: fixed-stride feature rows + a page directory, the
counterpart of `repro.storage.store`.

One file holds the whole entity table as contiguous float32 rows (stride
= d * 4 bytes), memory-mapped read-only; the format is the reference's,
so a file written by either package opens in the other with
`EntityStore(path, n, d, rows_per_page)` and reads the same bytes. Rows
are grouped into pages of `rows_per_page` consecutive entity ids;
`read_page` copies one page out of the map into a CPU tensor of its own
(no memory shared with the file) and is the unit of "disk" I/O the
`BufferPool` budgets and counts. The page directory maps entity id ->
(page, slot) explicitly.

The store is read-only: the maintenance state (labels, eps, orders) lives
in the engines, as the paper separates the clustered scratch table H from
the entity relation.
"""
from __future__ import annotations

import os
import tempfile
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.witness import assert_unlocked

PAGE_BYTES = 8192          # default page size (rows are grouped to ~8 KiB)


class EntityStore:
    """Memory-mapped (n, d) float32 entity table, paged by entity id."""

    def __init__(self, path: str, n: int, d: int, rows_per_page: int, *,
                 owns_file: bool = False):
        self.path = path
        self.n, self.d = int(n), int(d)
        self.stride = self.d * 4                      # bytes per row
        self.rows_per_page = max(1, int(rows_per_page))
        self.page_bytes = self.rows_per_page * self.stride
        self.num_pages = -(-self.n // self.rows_per_page)
        self._owns = owns_file
        self._mmap: Optional[np.memmap] = np.memmap(
            path, dtype=np.float32, mode="r", shape=(self.n, self.d))
        # page directory keyed by entity id: id -> (page, slot)
        ids = np.arange(self.n, dtype=np.int64)
        self.dir_page = ids // self.rows_per_page
        self.dir_slot = (ids % self.rows_per_page).astype(np.int32)
        self.page_reads = 0                           # cold I/O counter

    @classmethod
    def from_array(cls, F: np.ndarray, path: Optional[str] = None,
                   page_bytes: int = PAGE_BYTES) -> "EntityStore":
        """Write `F` to `path` (a private temp file, owned and removed by
        the store, if None) and map it."""
        F = np.ascontiguousarray(F, np.float32)
        n, d = F.shape
        if d < 1:
            raise ValueError("entity rows must have at least one feature")
        rows_per_page = max(1, int(page_bytes) // (d * 4))
        owns = path is None
        if owns:
            fd, path = tempfile.mkstemp(prefix="hazy-entity-", suffix=".f32")
            os.close(fd)
        F.tofile(path)
        return cls(path, n, d, rows_per_page, owns_file=owns)

    # -- geometry ------------------------------------------------------
    @property
    def nbytes(self) -> int:
        return self.n * self.stride

    def page_of(self, entity_id: int) -> int:
        return int(self.dir_page[entity_id])

    def slot_of(self, entity_id: int) -> int:
        return int(self.dir_slot[entity_id])

    def page_nbytes(self, page_id: int) -> int:
        lo = page_id * self.rows_per_page
        return (min(self.n, lo + self.rows_per_page) - lo) * self.stride

    def page_row_ids(self, page_id: int) -> np.ndarray:
        lo = page_id * self.rows_per_page
        return np.arange(lo, min(self.n, lo + self.rows_per_page))

    # -- I/O -----------------------------------------------------------
    # Both readers assert (witness-armed only) that the caller does NOT
    # hold the pool lock: a disk read is the blocking operation the async
    # read path keeps off that lock (static twin: LCK004).

    def read_page(self, page_id: int) -> torch.Tensor:
        """Copy one page out of the map — the 'disk read'."""
        if self._mmap is None:
            raise ValueError("entity store is closed")
        assert_unlocked("pool", "EntityStore.read_page disk I/O")
        lo = page_id * self.rows_per_page
        hi = min(self.n, lo + self.rows_per_page)
        self.page_reads += 1
        return torch.from_numpy(np.array(self._mmap[lo:hi]))

    def read_pages(self, page_ids: Sequence[int]) -> List[torch.Tensor]:
        """Batched `read_page`: one copy per CONTIGUOUS RUN of page ids,
        each page a view of its run's copy. Counts `len(page_ids)` page
        reads, as the equivalent `read_page` loop would, and returns the
        pages in the input order."""
        if self._mmap is None:
            raise ValueError("entity store is closed")
        assert_unlocked("pool", "EntityStore.read_pages disk I/O")
        pids = [int(p) for p in page_ids]
        self.page_reads += len(pids)
        out: List[torch.Tensor] = []
        i = 0
        while i < len(pids):
            j = i                              # maximal run pids[i..j]
            while j + 1 < len(pids) and pids[j + 1] == pids[j] + 1:
                j += 1
            lo = pids[i] * self.rows_per_page
            hi = min(self.n, (pids[j] + 1) * self.rows_per_page)
            block = torch.from_numpy(np.array(self._mmap[lo:hi]))
            for t in range(j - i + 1):
                a = t * self.rows_per_page
                b = min(a + self.rows_per_page, block.shape[0])
                out.append(block[a:b])
            i = j + 1
        return out

    def close(self):
        if self._mmap is not None:
            self._mmap = None
            if self._owns:
                try:
                    os.unlink(self.path)
                except OSError:
                    pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
