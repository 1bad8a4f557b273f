"""The port's paged KV cache bookkeeping (``repro_torch.serve.paged_kv``, host
numpy copied from the reference): ``tests/test_serving.py``'s three paged
tests on the port, and the port's tables against the reference's on the
same allocation sequence."""
import numpy as np
import pytest

from repro.serve import paged_kv as ref
from repro_torch.serve.paged_kv import (CompressedBlockTable, PagedKVCache,
                                        compressed_table)


def test_paged_alloc_and_slots():
    pool = PagedKVCache(n_pages=16, page_size=4)
    pool.alloc_request(1)
    pool.append_token_capacity(1, 10)          # -> 3 pages
    assert len(pool.tables[1]) == 3
    slots = pool.physical_slots(1, np.arange(10))
    assert len(set(slots.tolist())) == 10
    pool.alloc_request(2)
    pool.append_token_capacity(2, 5)
    assert pool.utilization() == pytest.approx(5 / 16)
    pool.release(1)
    assert pool.utilization() == pytest.approx(2 / 16)


def test_paged_pool_exhaustion():
    pool = PagedKVCache(n_pages=2, page_size=4)
    pool.alloc_request(1)
    with pytest.raises(MemoryError):
        pool.append_token_capacity(1, 100)


def test_compressed_block_table():
    pool = PagedKVCache(n_pages=64, page_size=16)
    pool.alloc_request(5)
    pool.append_token_capacity(5, 512)          # contiguous: 32 pages
    ct = compressed_table(pool, 5)
    assert ct.size_bytes() == 24                # one run
    logical = np.arange(32)
    np.testing.assert_array_equal(ct.lookup(logical),
                                  np.asarray(pool.tables[5])[logical])
    # fragmented table still resolves exactly
    frag = [5, 6, 7, 30, 31, 2, 3, 4]
    ct2 = CompressedBlockTable(frag)
    np.testing.assert_array_equal(ct2.lookup(np.arange(8)), frag)
    assert ct2.size_bytes() == 3 * 24


def test_interleaved_requests_match_reference():
    """Three requests growing in turns, one released and its pages reused:
    the same tables, slots, utilization and compressed lookups."""
    pools = [PagedKVCache(n_pages=40, page_size=8),
             ref.PagedKVCache(n_pages=40, page_size=8)]
    rng = np.random.default_rng(0)
    steps = [(int(rng.integers(3)), int(rng.integers(1, 30)))
             for _ in range(18)]
    for pool in pools:
        for rid in range(3):
            pool.alloc_request(rid)
        for i, (rid, n) in enumerate(steps):
            pool.append_token_capacity(rid, n)
            if i == 8:
                pool.release(1)
                pool.alloc_request(1)
    assert pools[0].tables == pools[1].tables
    assert pools[0].utilization() == pools[1].utilization()
    for rid in range(3):
        n = len(pools[0].tables[rid]) * 8
        pos = np.arange(n)
        np.testing.assert_array_equal(pools[0].physical_slots(rid, pos),
                                      pools[1].physical_slots(rid, pos))
        blocks = np.arange(len(pools[0].tables[rid]))
        np.testing.assert_array_equal(
            compressed_table(pools[0], rid).lookup(blocks),
            ref.compressed_table(pools[1], rid).lookup(blocks))
