"""Paged KV cache: fixed-size blocks, per-slot block tables, prefix reuse.

The port's own copy of ``repro.serving.paged_cache`` (numpy only; the
allocator's decisions must match the JAX engine's step for step, which
``tests/test_torch_serving.py`` checks).

The dense serving cache reserves ``max_seq`` KV rows per slot, so a
4k-context pool with short requests wastes almost all of its device
memory.  This module manages the paged alternative on the host: device KV
lives in a flat page pool (``models/params.zeros_state``) and every slot
owns an int32 *block table* mapping logical block ``i`` (positions
``[i*page_size, (i+1)*page_size)``) to a physical page.  Decode reads
through the table (``models/attention.paged_decode_attention``); the
engine passes the table into the decode step each tick.

Page 0 is the reserved *null page*: table entry 0 means "unmapped", and
masked/inactive-slot writes land there harmlessly.  The allocator hands
out pages ``1..pages-1`` from a free list and refcounts every page:

* a slot mapping a page holds one reference,
* the prefix index holds one reference per cached block.

Copy-on-write: a page with ``ref > 1`` is never written in place.
:meth:`ensure_writable` swaps a fresh page into the writing slot's table
and returns ``(src, dst)`` pairs; the engine turns them into on-device
page copies at the start of the decode step, so COW costs no extra
dispatch.

Prefix reuse hashes prompt tokens at block granularity into a chain
(``h_i = sha1(h_{i-1} || tokens of block i)``); full blocks are keyed by
their chain digest and a partially-filled tail block by
``(digest, tail-token tuple)``, so a hit can end mid-block.  A lookup
walks the reader's own blocks until the first miss, maps the matched
pages into the new slot's table and skips prefill for the shared span.
Entries are LRU-evicted (leaf-first, keeping chains contiguous) when the
pool runs dry.

Admission is reservation-based: :meth:`can_admit` only admits a request
if the free list plus evictable cache pages cover its worst-case block
need *and* every already-active slot's outstanding need — so an admitted
request can never deadlock on allocation mid-decode.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

Key = Tuple  # ("F", digest) for full blocks, ("P", digest, tokens) for tails


@dataclass
class _Entry:
    page: int
    ntok: int                      # tokens this block covers (== page_size
    parent: Optional[Key]          #   for full blocks, < page_size for tails)
    children: Set[Key] = field(default_factory=set)
    lru: int = 0


def _digest(prev: bytes, tokens: np.ndarray) -> bytes:
    return hashlib.sha1(prev + np.asarray(tokens, np.int32).tobytes()).digest()


class PagedKVCache:
    """Host-side page allocator + block tables + prefix index.

    ``pages`` counts physical pages *including* the reserved null page 0,
    matching the device pool's page axis."""

    def __init__(self, *, pages: int, page_size: int, slots: int,
                 max_seq: int, prefix_cache: bool = False):
        if page_size < 1:
            raise ValueError(f"page_size {page_size} must be >= 1")
        if max_seq % page_size != 0:
            raise ValueError(
                f"max_seq {max_seq} must be a multiple of page_size "
                f"{page_size} — equal logical cache length is what makes "
                f"paged decode bitwise-identical to the dense path")
        self.page_size = page_size
        self.pages = pages
        self.slots = slots
        self.max_seq = max_seq
        self.blocks_per_slot = max_seq // page_size
        if pages < self.blocks_per_slot + 1:
            raise ValueError(
                f"pool of {pages} pages cannot hold even one full slot "
                f"({self.blocks_per_slot} blocks + null page)")
        self.prefix_enabled = prefix_cache
        self.ref = np.zeros((pages,), np.int64)
        self.free: List[int] = list(range(pages - 1, 0, -1))  # pop() -> 1
        self.table = np.zeros((slots, self.blocks_per_slot), np.int32)
        # reservation bound per slot: exclusive end position the slot may
        # write up to over its lifetime (0 = slot inactive)
        self.slot_end = np.zeros((slots,), np.int64)
        self._index: Dict[Key, _Entry] = {}
        self._clock = 0
        self.stats = {"alloc": 0, "cow": 0, "evicted": 0,
                      "hit_tokens": 0, "lookup_tokens": 0}

    # ------------------------------------------------------------------
    # allocation
    # ------------------------------------------------------------------
    def _alloc(self) -> int:
        if not self.free:
            self._evict(need=1)
        if not self.free:
            raise RuntimeError(
                "paged KV pool exhausted — admission reservations should "
                "make this unreachable (engine invariant violation)")
        pg = self.free.pop()
        assert self.ref[pg] == 0
        self.ref[pg] = 1
        self.stats["alloc"] += 1
        return pg

    def _unref(self, pg: int):
        self.ref[pg] -= 1
        if self.ref[pg] == 0:
            self.free.append(pg)
        assert self.ref[pg] >= 0

    def ensure_writable(self, slot: int, start_pos: int,
                        end_pos: int) -> List[Tuple[int, int]]:
        """Make blocks covering positions [start_pos, end_pos] exist and be
        exclusively owned by ``slot``; returns (src, dst) page pairs the
        engine must copy on device before the step writes."""
        end_pos = min(end_pos, self.max_seq - 1)
        cow: List[Tuple[int, int]] = []
        for li in range(start_pos // self.page_size,
                        end_pos // self.page_size + 1):
            pg = int(self.table[slot, li])
            if pg == 0:
                self.table[slot, li] = self._alloc()
            elif self.ref[pg] > 1:          # shared: copy-on-write
                new = self._alloc()
                cow.append((pg, new))
                self._unref(pg)
                self.table[slot, li] = new
                self.stats["cow"] += 1
        return cow

    def release(self, slot: int):
        """Return every page the slot maps to the pool (refcount-aware:
        pages shared with the prefix index or other slots stay alive)."""
        for li in range(self.blocks_per_slot):
            pg = int(self.table[slot, li])
            if pg:
                self._unref(pg)
        self.table[slot] = 0
        self.slot_end[slot] = 0

    def mapped(self, slot: int) -> int:
        return int(np.count_nonzero(self.table[slot]))

    # ------------------------------------------------------------------
    # admission reservations
    # ------------------------------------------------------------------
    def _slot_need(self, slot: int) -> int:
        """Worst-case pages slot may still allocate: blocks to reach its
        reserved end, plus one COW page if it maps any shared block."""
        if self.slot_end[slot] == 0:
            return 0
        total = -(-int(self.slot_end[slot]) // self.page_size)
        need = max(0, total - self.mapped(slot))
        if any(self.ref[pg] > 1 for pg in self.table[slot] if pg):
            need += 1
        return need

    def _evictable(self) -> int:
        return sum(1 for e in self._index.values() if self.ref[e.page] == 1)

    def can_admit(self, prompt_len: int, max_new: int, *,
                  shared_pages: int = 0, headroom: int = 0) -> bool:
        """True if the pool can cover this request's worst case on top of
        every active slot's outstanding reservation."""
        end = min(prompt_len + max_new + 1 + headroom, self.max_seq)
        need = -(-end // self.page_size) - shared_pages
        if shared_pages:
            need += 1                      # possible COW of the shared tail
        outstanding = sum(self._slot_need(s) for s in range(self.slots))
        return need + outstanding <= len(self.free) + self._evictable()

    def admit(self, slot: int, prompt_len: int, max_new: int, *,
              headroom: int = 0,
              shared: Optional[List[int]] = None):
        """Record the slot's lifetime reservation and map shared prefix
        pages (each mapping takes a reference)."""
        self.slot_end[slot] = min(prompt_len + max_new + 1 + headroom,
                                  self.max_seq)
        if shared:
            for li, pg in enumerate(shared):
                self.table[slot, li] = pg
                self.ref[pg] += 1

    # ------------------------------------------------------------------
    # prefix index
    # ------------------------------------------------------------------
    def lookup(self, tokens: np.ndarray) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: (pages, shared token count).
        Walks full blocks by chain digest, then probes the tail at every
        length — a hit may be shorter or longer than one block."""
        if not self.prefix_enabled:
            return [], 0
        self.stats["lookup_tokens"] += len(tokens)
        bs = self.page_size
        pages: List[int] = []
        span = 0
        h = b""
        while span + bs <= len(tokens):
            h2 = _digest(h, tokens[span:span + bs])
            ent = self._index.get(("F", h2))
            if ent is None:
                break
            self._touch(("F", h2))
            pages.append(ent.page)
            span += bs
            h = h2
        rest = tokens[span:]
        for ln in range(min(len(rest), bs - 1), 0, -1):
            key = ("P", h, tuple(int(t) for t in rest[:ln]))
            ent = self._index.get(key)
            if ent is not None:
                self._touch(key)
                pages.append(ent.page)
                span += ln
                break
        self.stats["hit_tokens"] += span
        return pages, span

    def insert(self, slot: int, tokens: np.ndarray):
        """Register the slot's (fully written) prompt blocks in the index.
        Each newly indexed page gains a cache-held reference; blocks
        already present are left as-is (first writer wins)."""
        if not self.prefix_enabled:
            return
        bs = self.page_size
        h = b""
        parent: Optional[Key] = None
        for li in range(len(tokens) // bs):
            h = _digest(h, tokens[li * bs:(li + 1) * bs])
            parent = self._link(("F", h), int(self.table[slot, li]),
                                bs, parent)
        tail = tokens[(len(tokens) // bs) * bs:]
        if len(tail):
            key = ("P", h, tuple(int(t) for t in tail))
            self._link(key, int(self.table[slot, len(tokens) // bs]),
                       len(tail), parent)

    def _link(self, key: Key, page: int, ntok: int,
              parent: Optional[Key]) -> Key:
        ent = self._index.get(key)
        if ent is None:
            assert page > 0, "prefix insert before the block was written"
            self._clock += 1
            self._index[key] = _Entry(page=page, ntok=ntok, parent=parent,
                                      lru=self._clock)
            self.ref[page] += 1
            if parent is not None:
                self._index[parent].children.add(key)
        else:
            self._touch(key)
        return key

    def _touch(self, key: Key):
        self._clock += 1
        self._index[key].lru = self._clock

    def _evict(self, need: int):
        """Drop LRU leaf entries until ``need`` pages are free (leaf-first
        keeps every remaining chain reachable from block 0)."""
        while len(self.free) < need:
            leaves = [(e.lru, k) for k, e in self._index.items()
                      if not e.children]
            if not leaves:
                return
            _, key = min(leaves)
            ent = self._index.pop(key)
            if ent.parent is not None and ent.parent in self._index:
                self._index[ent.parent].children.discard(key)
            self._unref(ent.page)
            self.stats["evicted"] += 1

    # ------------------------------------------------------------------
    # invariants
    # ------------------------------------------------------------------
    def check(self):
        """Full accounting audit; raises RuntimeError on any leak or
        double-free.  Cheap enough to run at every slot release."""
        counts = np.zeros_like(self.ref)
        for s in range(self.slots):
            for pg in self.table[s]:
                if pg:
                    counts[pg] += 1
        for e in self._index.values():
            counts[e.page] += 1
        free_set = set(self.free)
        if len(free_set) != len(self.free):
            raise RuntimeError("paged cache: duplicate pages in free list")
        if 0 in free_set:
            raise RuntimeError("paged cache: null page 0 entered free list")
        for pg in range(1, self.pages):
            if counts[pg] != self.ref[pg]:
                raise RuntimeError(
                    f"paged cache: page {pg} refcount {self.ref[pg]} != "
                    f"{counts[pg]} holders (leak or double-map)")
            if (self.ref[pg] == 0) != (pg in free_set):
                raise RuntimeError(
                    f"paged cache: page {pg} ref={self.ref[pg]} but "
                    f"{'not ' if pg not in free_set else ''}in free list")
        for key, e in self._index.items():
            if e.parent is not None and e.parent in self._index \
                    and key not in self._index[e.parent].children:
                raise RuntimeError("paged cache: broken chain linkage")

    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def index_size(self) -> int:
        return len(self._index)
