"""Paged KV cache: fixed-size physical pages + per-request block tables.

The allocator is append-only per request with a free list (vLLM-style).  For
long contexts the *logical -> physical* block table of a request is usually
monotone over long runs (allocation bursts), which is the paper's compressible
shape: ``compressed_table()`` stores it as a FITing-tree segment table and
``CompressedBlockTable.lookup`` resolves blocks with a bounded probe --
(524288 tokens / 128-token pages = 4096 entries -> a handful of segments when
allocation is contiguous; falls back to one segment per fragmented run).
"""
from __future__ import annotations

import dataclasses

import numpy as np



@dataclasses.dataclass
class PagedKVCache:
    """Physical page pool for one layer group.  Host-side bookkeeping;
    the device arrays are (n_pages, page, kv_heads, hd) gathered per step."""
    n_pages: int
    page_size: int

    def __post_init__(self):
        self.free = list(range(self.n_pages - 1, -1, -1))
        self.tables: dict[int, list[int]] = {}
        self._used: dict[int, int] = {}

    def alloc_request(self, rid: int):
        if rid in self.tables:
            raise KeyError(f"request {rid} already active")
        self.tables[rid] = []
        self._used[rid] = 0

    def append_token_capacity(self, rid: int, n_tokens: int) -> list[int]:
        """Ensure capacity for n_tokens more tokens; returns new page ids."""
        table = self.tables[rid]
        need_pages = -(-(self._used[rid] + n_tokens) // self.page_size) \
            - len(table)
        newly = []
        for _ in range(need_pages):
            if not self.free:
                raise MemoryError("KV pool exhausted")
            p = self.free.pop()
            table.append(p)
            newly.append(p)
        self._used[rid] += n_tokens
        return newly

    def release(self, rid: int):
        for p in self.tables.pop(rid):
            self.free.append(p)
        self._used.pop(rid, None)

    def physical_slots(self, rid: int, positions: np.ndarray) -> np.ndarray:
        """token position -> physical slot = page_id * page_size + offset."""
        table = np.asarray(self.tables[rid])
        return (table[positions // self.page_size] * self.page_size
                + positions % self.page_size)

    def utilization(self) -> float:
        return 1.0 - len(self.free) / self.n_pages


class CompressedBlockTable:
    """FITing-tree-compressed logical->physical block table (error=0 exact:
    contiguous runs collapse to one segment each)."""

    def __init__(self, table: list[int]):
        self.n = len(table)
        # index the (logical, physical) pairs: key = logical id, position =
        # physical id. Monotone runs compress; error=1 keeps probes exact
        # after rounding since physical ids are integers.
        self.runs_start_logical = []
        self.runs_start_physical = []
        self.runs_len = []
        i = 0
        while i < self.n:
            j = i
            while j + 1 < self.n and table[j + 1] == table[j] + 1:
                j += 1
            self.runs_start_logical.append(i)
            self.runs_start_physical.append(table[i])
            self.runs_len.append(j - i + 1)
            i = j + 1
        self.runs_start_logical = np.asarray(self.runs_start_logical)
        self.runs_start_physical = np.asarray(self.runs_start_physical)

    def size_bytes(self) -> int:
        return len(self.runs_len) * 24

    def lookup(self, logical: np.ndarray) -> np.ndarray:
        r = np.searchsorted(self.runs_start_logical, logical, "right") - 1
        return (self.runs_start_physical[r]
                + (logical - self.runs_start_logical[r]))


def compressed_table(pool: PagedKVCache, rid: int) -> CompressedBlockTable:
    return CompressedBlockTable(pool.tables[rid])
