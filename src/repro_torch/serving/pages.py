"""Host-side page allocator for the paged KV-cache (generalizes SlotPool).

A port of ``repro.serving.pages``.  Per model and per attention layer the
device holds a ``(num_pages + scratch + 1, page_size, KV, hd)`` K/V pool,
plus ONE per-slot block table ``pt: (B, nblk + 1) int32`` shared by all three
models (draft / target / PRM advance ``pos`` in lockstep, so page ``p`` is
row ``p`` of every pool).  :class:`PagePool` is the ledger over the
``num_pages`` allocatable ids:

  * **reservation** — admission claims a request's worst-case page count up
    front (``claim``); the scheduler defers queued requests while
    ``can_claim`` is False (backpressure, never drops).
  * **lazy assignment** — pages are assigned to table blocks as ``pos``
    approaches them (``ensure``).
  * **refcounted sharing** — a page may back the same block of several
    slots; ``release`` decrements, and a page leaves circulation when its
    last reader drops it.
  * **content-addressed reuse** — an attached :class:`RadixIndex` keys
    full, committed pages by their token chunk (``match`` / ``publish``);
    retained pages survive their last reader in a ``cached`` LRU set.
  * **eviction over deferral** — ``claim`` evicts least-recently-used
    unreferenced cached pages before giving up.

Every allocatable page is on the ``free`` list, *referenced* or *cached*,
and ``free + referenced + cached == num_pages`` always holds.  Beyond the
allocatable ids the pools carry ``batch * n * span`` scratch pages for
copy-on-write candidate branching and one trash page (the last row).

A quantized pool (``kv_dtype`` int8 or fp8) also tracks ``scale_slots``,
the pages whose per-page scales are live on the device: claimed with the
page's first reference, released when the page returns to the free list,
so ``scale_slots == referenced | cached`` always holds.  Eviction is
bytes-weighted (``page_cost``): among cached pages the one minimizing
``clock / cost`` goes first, which is plain LRU when costs are uniform.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.kernels import quant
from repro_torch.serving.radix import RadixIndex


def pages_for(positions: int, page_size: int) -> int:
    """Pages needed to hold ``positions`` cache positions (ceil)."""
    return -(-positions // page_size)


@dataclass
class PagePool:
    """Ledger over ``num_pages`` allocatable page ids (0..num_pages-1)."""
    num_pages: int
    page_size: int
    index: Optional[RadixIndex] = None    # attached = prefix caching on
    kv_dtype: Optional[str] = None        # page storage format (see quant)
    page_bytes: int = 0                   # bytes per page (0 = uniform LRU)
    page_cost_override: Dict[int, int] = field(default_factory=dict)
    free: List[int] = field(default=None)
    claimed: Dict[int, int] = field(default_factory=dict)   # slot -> unassigned claim
    assigned: Dict[int, List[int]] = field(default_factory=dict)  # slot -> pages by block
    refcount: Dict[int, int] = field(default_factory=dict)  # page -> live slot refs (>0)
    retained: Set[int] = field(default_factory=set)         # pages held by the index
    cached: Set[int] = field(default_factory=set)           # retained, refcount == 0
    scale_slots: Set[int] = field(default_factory=set)      # pages w/ live scales
    evicted: int = 0              # lifetime cached pages evicted (stats)
    peak_assigned: int = 0        # peak distinct referenced pages
    peak_in_use: int = 0          # referenced + outstanding claims

    def __post_init__(self):
        """Seed the free list with every allocatable page id."""
        quant.validate_kv_dtype(self.kv_dtype)
        if self.free is None:
            # pop() takes from the end: keep ids ascending for readability
            self.free = list(range(self.num_pages - 1, -1, -1))

    @property
    def quantized(self) -> bool:
        """True when pages carry per-page scale tensors (int8 / fp8)."""
        return quant.is_quantized(self.kv_dtype)

    # -- queries -------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self.free)

    @property
    def num_assigned(self) -> int:
        """Slot-side view: sum of per-slot block counts."""
        return sum(len(v) for v in self.assigned.values())

    @property
    def num_referenced(self) -> int:
        """Distinct pages with at least one live slot reference."""
        return len(self.refcount)

    @property
    def num_cached(self) -> int:
        """Unreferenced pages retained by the radix index (evictable)."""
        return len(self.cached)

    @property
    def num_claimed(self) -> int:
        """Pages reserved by admission control but not yet assigned."""
        return sum(self.claimed.values())

    @property
    def num_in_use(self) -> int:
        return self.num_referenced + self.num_claimed

    def can_claim(self, pages: int, shared: Sequence[int] = ()) -> bool:
        """Would a ``pages``-page claim (on top of ``shared`` matched pages
        about to be pinned) fit, counting LRU-evictable cached pages?"""
        evictable = self.num_cached - sum(1 for p in shared
                                          if p in self.cached)
        return self.num_free + evictable - self.num_claimed >= pages

    def blocks_assigned(self, slot: int) -> int:
        return len(self.assigned.get(slot, ()))

    def max_blocks(self, slot: int) -> int:
        """Ceiling on the slot's table blocks: assigned + remaining claim."""
        return len(self.assigned.get(slot, ())) + self.claimed.get(slot, 0)

    # -- refcount plumbing ---------------------------------------------
    def _ref(self, page: int) -> None:
        rc = self.refcount.get(page, 0)
        if rc == 0:
            self.cached.discard(page)     # referenced pages leave the LRU
            if self.quantized:
                self.scale_slots.add(page)    # claimed with the page
        self.refcount[page] = rc + 1

    def _unref(self, page: int) -> None:
        rc = self.refcount[page] - 1
        if rc > 0:
            self.refcount[page] = rc
            return
        del self.refcount[page]
        if page in self.retained:
            self.cached.add(page)         # survives: radix cache entry
        else:
            self._free(page)

    def _free(self, page: int) -> None:
        """Return a page to the free list; its scale slot goes with it."""
        self.free.append(page)
        self.scale_slots.discard(page)

    # -- prefix cache --------------------------------------------------
    def match(self, tokens) -> Tuple[List[int], int]:
        """Radix lookup: (shareable pages, matched token count)."""
        if self.index is None:
            return [], 0
        return self.index.match(tokens)

    def publish(self, tokens, pages: Sequence[int]) -> int:
        """Register a prompt's full committed pages in the radix index;
        returns the number of pages newly retained.  The caller must hold a
        reference to every page it publishes."""
        if self.index is None or not pages:
            return 0
        if any(p not in self.refcount for p in pages):
            raise ValueError(
                "publish requires the caller to hold a reference to "
                "every published page")
        new = self.index.insert(tokens, pages)
        self.retained.update(new)
        return len(new)

    def page_cost(self, page: int) -> int:
        """Eviction cost of a cached page, in bytes: the pool-wide
        ``page_bytes`` (the engine wires in one page's payload plus scales,
        so a cached int8 page costs half a bf16 one) unless
        ``page_cost_override`` names the page; 0 everywhere is plain LRU."""
        return self.page_cost_override.get(page, self.page_bytes) or 1

    def evict(self, need: int) -> int:
        """Evict cached pages (whole radix subtrees, lowest ``clock / cost``
        first) until ``need`` are freed; returns how many were freed.
        Still-referenced pages of a dropped subtree only lose their
        retention and are freed by their last ``release``."""
        freed = 0
        while freed < need and self.cached:
            page = self.index.lru_page(self.cached, cost=self.page_cost)
            if page is None:              # cached page vanished from trie
                stray = self.cached.pop()
                self.retained.discard(stray)
                self._free(stray)
                freed += 1
                self.evicted += 1
                continue
            for p in self.index.drop_subtree(page):
                self.retained.discard(p)
                if p in self.cached:
                    self.cached.remove(p)
                    self._free(p)
                    freed += 1
                    self.evicted += 1
        return freed

    # -- transitions ---------------------------------------------------
    def claim(self, slot: int, pages: int,
              shared: Sequence[int] = ()) -> None:
        """Reserve ``pages`` tail pages for ``slot``, seeding its block
        table with the matched ``shared`` pages (pinned before any
        eviction the claim triggers)."""
        if slot in self.claimed or slot in self.assigned:
            raise ValueError(f"slot {slot} already holds a claim")
        for p in shared:
            self._ref(p)
        deficit = pages - (self.num_free - self.num_claimed)
        if deficit > 0:
            self.evict(deficit)
        if self.num_free - self.num_claimed < pages:
            for p in shared:              # unwind the pins
                self._unref(p)
            raise ValueError(
                f"cannot claim {pages} pages: {self.num_free} free, "
                f"{self.num_cached} cached, "
                f"{self.num_claimed} already claimed")
        self.claimed[slot] = pages
        self.assigned[slot] = list(shared)
        self.peak_assigned = max(self.peak_assigned, self.num_referenced)
        self.peak_in_use = max(self.peak_in_use, self.num_in_use)

    def ensure(self, slot: int, nblocks: int) -> List[Tuple[int, int]]:
        """Assign pages so ``slot`` covers table blocks [0, nblocks);
        returns the new (block, page) pairs."""
        if slot not in self.assigned:
            raise ValueError(f"slot {slot} has no claim")
        pages = self.assigned[slot]
        new = []
        while len(pages) < nblocks:
            if self.claimed[slot] <= 0:
                raise ValueError(
                    f"slot {slot} exceeded its page claim (needs block "
                    f"{len(pages)}; admission control under-reserved)")
            page = self.free.pop()
            self.claimed[slot] -= 1
            self._ref(page)
            new.append((len(pages), page))
            pages.append(page)
        if new:
            self.peak_assigned = max(self.peak_assigned,
                                     self.num_referenced)
        return new

    def release(self, slot: int) -> int:
        """Drop the slot's references and its remaining claim (no
        zeroing: the decode mask hides every position beyond ``pos``)."""
        if slot not in self.assigned:
            raise ValueError(f"slot {slot} has no claim")
        pages = self.assigned.pop(slot)
        for page in reversed(pages):
            self._unref(page)
        self.claimed.pop(slot, None)
        return len(pages)
