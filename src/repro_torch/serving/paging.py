"""Paged KV cache: the block-pool allocator and prefix caching.

The port of the JAX package's ``repro.serving.paging``; every decision is
host-side and the same as there:

* ``BlockPool`` — a fixed pool of ``num_blocks`` pages, each covering
  ``block_size`` token positions across all layers: free list, per-page
  reference counts, copy-on-write forking, and an LRU of evictable
  (refcount-0 but content-cached) pages.
* prefix caching — full pages are registered under a chain hash of their
  tokens (``h_i = hash((h_{i-1}, tokens_i))``); a prompt sharing a
  page-aligned prefix with an earlier one reuses the cached pages (a
  refcount bump, no write).  Freed pages stay cached until capacity
  pressure reclaims them.
* ``PagedKVCache`` — the device pool (``(num_blocks, L, Hkv, block_size, ·)``
  K/V leaves, see ``models.transformer.init_paged_pool``) with the per-slot
  page tables the paged decode kernels walk.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.staging import StagedTensor
from repro_torch.quant.kv_quant import QuantKV, payload_bytes, total_nbytes


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


class PoolExhausted(RuntimeError):
    """No free or evictable page available — the caller must free or preempt."""


@dataclasses.dataclass
class PageMeta:
    refcount: int = 0
    hash: Optional[int] = None  # prefix-cache registration, if any
    tokens: Optional[Tuple[int, ...]] = None  # the registered page's exact tokens


@dataclasses.dataclass
class PoolStats:
    allocs: int = 0
    frees: int = 0
    prefix_hits: int = 0
    prefix_misses: int = 0
    cache_evictions: int = 0
    cow_copies: int = 0


class BlockPool:
    """Fixed pool of KV pages with refcounts, COW and prefix caching.

    Invariants: every page is in exactly one of {free list, evictable LRU,
    live (refcount > 0)}; a page in the evictable LRU has refcount 0 and a
    registered hash; ``decref`` of a live unregistered page returns it to
    the free list.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError(f"a pool needs num_blocks > 0 and block_size > 0, "
                             f"got {num_blocks}, {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.meta: List[PageMeta] = [PageMeta() for _ in range(num_blocks)]
        self.free_list: deque[int] = deque(range(num_blocks))
        self.hash_to_page: Dict[int, int] = {}
        self.evictable: "OrderedDict[int, None]" = OrderedDict()  # LRU order
        self.stats = PoolStats()

    @property
    def num_free(self) -> int:
        """Pages immediately allocatable (fresh + cache-evictable)."""
        return len(self.free_list) + len(self.evictable)

    @property
    def num_live(self) -> int:
        return sum(1 for m in self.meta if m.refcount > 0)

    def refcount(self, pid: int) -> int:
        return self.meta[pid].refcount

    def alloc(self) -> int:
        """Allocate one page (refcount 1), evicting a cached page if needed."""
        if self.free_list:
            pid = self.free_list.popleft()
        elif self.evictable:
            pid, _ = self.evictable.popitem(last=False)  # LRU victim
            self._unregister(pid)
            self.stats.cache_evictions += 1
        else:
            raise PoolExhausted(f"block pool exhausted: {self.num_blocks} pages all live")
        m = self.meta[pid]
        assert m.refcount == 0
        m.refcount = 1
        self.stats.allocs += 1
        return pid

    def incref(self, pid: int) -> None:
        assert self.meta[pid].refcount > 0, "incref on a dead page"
        self.meta[pid].refcount += 1

    def decref(self, pid: int) -> int:
        """Drop one reference; a refcount-0 page becomes evictable (if it is
        prefix-registered) or free."""
        m = self.meta[pid]
        assert m.refcount > 0, "decref on a dead page"
        m.refcount -= 1
        if m.refcount == 0:
            self.stats.frees += 1
            if m.hash is not None:
                self.evictable[pid] = None  # most recently freed = MRU
            else:
                self.free_list.append(pid)
        return m.refcount

    def evict_all_cached(self) -> int:
        """Reclaim every evictable page into the free list; returns how many.
        The admission livelock breaker's last resort."""
        n = 0
        while self.evictable:
            pid, _ = self.evictable.popitem(last=False)
            self._unregister(pid)
            self.free_list.append(pid)
            self.stats.cache_evictions += 1
            n += 1
        return n

    def copy_on_write(self, pid: int) -> Tuple[int, bool]:
        """Prepare ``pid`` for writing: a uniquely held page is returned as
        it is; a shared one is forked (the caller copies the device
        contents to the fresh page, other holders keep ``pid``)."""
        if self.meta[pid].refcount == 1:
            return pid, False
        new = self.alloc()
        self.decref(pid)
        self.stats.cow_copies += 1
        return new, True

    @staticmethod
    def chain_hash(prev_hash: Optional[int], tokens: Sequence[int]) -> int:
        """Hash of one full page's tokens chained on its prefix's hash (a
        tuple of ints hashes the same in every process)."""
        return hash((prev_hash, tuple(int(t) for t in tokens)))

    def lookup(self, h: int, tokens: Optional[Sequence[int]] = None) -> Optional[int]:
        """Prefix-cache probe.  On a hit the page is revived or increffed and
        the caller owns one reference; ``tokens`` guards against chain-hash
        collisions."""
        pid = self.hash_to_page.get(h)
        if pid is None:
            self.stats.prefix_misses += 1
            return None
        m = self.meta[pid]
        if tokens is not None and m.tokens != tuple(int(t) for t in tokens):
            self.stats.prefix_misses += 1
            return None
        if m.refcount == 0:
            del self.evictable[pid]
            m.refcount = 1
        else:
            m.refcount += 1
        self.stats.prefix_hits += 1
        return pid

    def register(self, h: int, pid: int, tokens: Optional[Sequence[int]] = None) -> None:
        """Publish a fully written page under its chain hash."""
        if h in self.hash_to_page:
            return  # identical content already cached; keep the older page
        self.meta[pid].hash = h
        self.meta[pid].tokens = None if tokens is None else tuple(int(t) for t in tokens)
        self.hash_to_page[h] = pid

    def _unregister(self, pid: int) -> None:
        h = self.meta[pid].hash
        if h is not None and self.hash_to_page.get(h) == pid:
            del self.hash_to_page[h]
        self.meta[pid].hash = None
        self.meta[pid].tokens = None


@dataclasses.dataclass
class PrefixMatch:
    """Result of allocating a prompt's pages against the prefix cache."""

    pages: List[int]
    cached_pages: int  # leading pages served from the prefix cache
    # (hash, pid, tokens) of newly written full pages, registered after the write
    new_full_hashes: List[Tuple[int, int, Tuple[int, ...]]]


class PagedKVCache:
    """The device page pool + per-slot page tables over a ``BlockPool``.

    Position ``p`` of slot ``b`` lives at
    ``pool[table[b][p // block_size], :, :, p % block_size]``.
    """

    def __init__(self, pool_kv, *, n_slots: int, max_len: int, block_size: int):
        self.kv = pool_kv  # KVCache of (N, L, Hkv, bs, ·) tensors or QuantKV leaves
        self.block_size = block_size
        self.max_len = max_len
        self.max_pages = cdiv(max_len, block_size)
        first = pool_kv.k.q if isinstance(pool_kv.k, QuantKV) else pool_kv.k
        self.device = first.device
        self.pool = BlockPool(first.shape[0], block_size)
        self.tables: List[List[int]] = [[] for _ in range(n_slots)]
        self.peak_live_pages = 0
        self._tables_dirty = True
        # the tables in a static device tensor, written in place on a change
        self._tables_dev = StagedTensor((n_slots, self.max_pages), torch.int32, self.device)

    @property
    def num_blocks(self) -> int:
        return self.pool.num_blocks

    def page_bytes(self) -> int:
        """Bytes of one page: K + V payload plus (quantized) the scale planes."""
        return total_nbytes(self.kv) // self.num_blocks

    def page_payload_bytes(self) -> int:
        """Packed K/V payload bytes of one page, scales excluded."""
        return payload_bytes(self.kv) // self.num_blocks

    def pool_bytes(self) -> int:
        return self.num_blocks * self.page_bytes()

    def _note_usage(self) -> None:
        self.peak_live_pages = max(self.peak_live_pages, self.pool.num_live)

    def allocate_prompt(self, slot: int, tokens: np.ndarray) -> PrefixMatch:
        """Allocate pages for a prompt, serving page-aligned prefixes from
        the cache.  On ``PoolExhausted`` every page taken so far is given
        back, so a rejected admission leaves the pool as it was."""
        assert not self.tables[slot], f"slot {slot} already holds pages"
        bs = self.block_size
        n = len(tokens)
        n_pages = cdiv(n, bs)
        n_full = n // bs
        pages: List[int] = []
        new_full: List[Tuple[int, int, Tuple[int, ...]]] = []
        cached = 0
        h: Optional[int] = None
        try:
            matching = True
            for i in range(n_pages):
                if i < n_full:
                    chunk = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
                    h = BlockPool.chain_hash(h, chunk)
                    if matching:
                        pid = self.pool.lookup(h, chunk)
                        if pid is not None:
                            pages.append(pid)
                            cached += 1
                            continue
                        matching = False  # past the shared prefix: all miss
                    else:
                        self.pool.stats.prefix_misses += 1
                    pid = self.pool.alloc()
                    new_full.append((h, pid, chunk))
                else:
                    pid = self.pool.alloc()  # trailing partial page: never cached
                pages.append(pid)
        except PoolExhausted:
            for pid in pages:
                self.pool.decref(pid)
            raise
        self.tables[slot] = pages
        self._tables_dirty = True
        self._note_usage()
        return PrefixMatch(list(pages), cached, new_full)

    def register_prompt_pages(self, match: PrefixMatch) -> None:
        """Publish the freshly written full pages to the prefix cache."""
        for h, pid, chunk in match.new_full_hashes:
            self.pool.register(h, pid, chunk)

    def ensure_append_page(self, slot: int, length: int):
        """Make position ``length`` writable for ``slot``: grow the table by
        one page at a page boundary, or fork a shared page (copy-on-write).
        Returns the ``(dst_page, src_page)`` device copy the caller must make,
        or None.  Raises ``PoolExhausted`` when the pool cannot grow."""
        table = self.tables[slot]
        idx = length // self.block_size
        if idx == len(table):
            table.append(self.pool.alloc())
            self._tables_dirty = True
            self._note_usage()
            return None
        assert idx < len(table), (slot, length, table)
        pid = table[idx]
        if self.pool.refcount(pid) > 1:
            new, copied = self.pool.copy_on_write(pid)
            if copied:
                table[idx] = new
                self._tables_dirty = True
                self._note_usage()
                return (new, pid)
        return None

    def release_slot(self, slot: int) -> None:
        for pid in self.tables[slot]:
            self.pool.decref(pid)
        self.tables[slot] = []
        self._tables_dirty = True

    def block_tables_array(self) -> torch.Tensor:
        """(n_slots, max_pages) int32 on the pool's device; unused entries 0
        (never read: the walk stops at each slot's length).  One static
        tensor, written in place only after a table changed."""
        if self._tables_dirty:
            arr = np.zeros((len(self.tables), self.max_pages), np.int32)
            for i, t in enumerate(self.tables):
                arr[i, :len(t)] = t
            self._tables_dev.upload(arr)
            self._tables_dirty = False
        return self._tables_dev.dev

    def page_ids_for_write(self, match: PrefixMatch, padded_pages: int,
                           first_page: int = 0) -> torch.Tensor:
        """(padded_pages,) int32 destination pages, on the host, for the
        page write covering prompt pages [first_page, first_page +
        padded_pages): the whole prompt for the monolithic swap, one chunk's
        span for chunked prefill.  Cache-hit pages (shared, already holding
        these tokens) and the bucket's padding pages get the skip id
        ``num_blocks``, which the write leaves out."""
        ids = np.full((padded_pages,), self.num_blocks, np.int32)
        for i in range(padded_pages):
            if match.cached_pages <= first_page + i < len(match.pages):
                ids[i] = match.pages[first_page + i]
        return torch.from_numpy(ids)
