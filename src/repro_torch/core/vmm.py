"""VMM — the page allocator behind the paged KV pool.

Counterpart of ``repro/core/vmm.py``: :class:`PagedAllocator` (page-granular
allocation with a free list and reference counts), its typed errors and
``audit()``, copied as they are (numpy and plain Python). The reference's
sharding page table and software TLB belong to its JAX mesh and are not
part of the serving path.

Ownership boundaries & invariants (the serving stack builds on these):
  * This module owns *page identity only* — which physical page ids exist,
    who holds references to them, and which are free. It never touches page
    *contents*; data movement belongs to serve/kvcache.py (device pools).
  * Every page is either on the free list or refcounted (never both, never
    neither) — ``audit()`` enforces the partition and raises :class:`VmmError`
    on drift.
  * A page's refcount is the number of holders: each sequence that has the
    page in its page list counts once (``alloc_pages`` / ``adopt_pages``),
    plus one per external retain (``retain_pages`` — the prefix cache's
    handle). A page returns to the free list only when the *last* reference
    drops; freeing never yanks a page another holder still reads — that is
    the HEROv2 zero-copy-sharing guarantee at the allocator level.
  * Misuse raises typed errors (:class:`DoubleFreeError`,
    :class:`StaleSequenceError`, :class:`PageOutOfMemoryError`) instead of
    asserting or silently no-opping, so engine-level deadlock-breaker code
    can catch and recover.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import addrspace


class VmmError(RuntimeError):
    """Base class for typed allocator errors.

    Engine-level recovery code (deadlock breakers, eviction paths) catches
    this instead of bare AssertionError/KeyError, so a misuse surfaces as a
    recoverable condition rather than an interpreter-dependent crash."""


class PageOutOfMemoryError(VmmError, MemoryError):
    """The free list cannot cover an allocation (also a MemoryError, so
    pre-refcount callers that catch MemoryError keep working)."""


class DoubleFreeError(VmmError):
    """A page reference was dropped more times than it was taken (freeing a
    non-resident sequence, releasing an already-free page)."""


class StaleSequenceError(VmmError):
    """An operation named a sequence (or slot) the allocator does not know —
    a handle that was already freed or never existed."""


class PagedAllocator:
    """Page-granular allocator for paged KV caches (serve/kvcache.py).

    Pages are fixed-size token blocks; sequences own ordered page lists. The
    *global page id → byte offset* product can exceed 2³¹ for 500k-context
    caches, so offsets go through addrspace promotion (the mixed-data-model
    point, applied where it genuinely bites).

    Pages are **ref-counted** so several sequences (and the serve-side prefix
    cache) can reference the *same* physical page — HEROv2's shared-address-
    space move applied to KV prefixes. ``adopt_pages`` adds an existing
    page to a new sequence's list (share), ``fork_page`` replaces a shared
    page with a freshly allocated private one (the copy half of copy-on-write
    is the caller's job — this class never touches contents), and
    ``retain_pages``/``release_pages`` are raw reference handles for
    non-sequence holders. A page is freed only when its last reference drops.
    """

    def __init__(self, n_pages: int, page_tokens: int, token_bytes: int):
        self.n_pages = n_pages
        self.page_tokens = page_tokens
        self.token_bytes = token_bytes
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._seq_pages: Dict[int, List[int]] = {}
        self._refcount: Dict[int, int] = {}     # page id -> live references
        self._seq_private: Dict[int, int] = {}  # pages drawn from the free
        #                                         list on a seq's behalf
        #                                         (alloc/extend/fork — not
        #                                         adopted shares)

    @property
    def page_bytes(self) -> int:
        return self.page_tokens * self.token_bytes

    def offset_dtype(self):
        """int32 or int64 byte offsets? — the promotion analysis."""
        return addrspace.index_dtype((self.n_pages,), itemsize=self.page_bytes)

    # -- reference plumbing ------------------------------------------------
    def _pop_free(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PageOutOfMemoryError(
                f"paged KV: need {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refcount[p] = 1
        return pages

    def _decref(self, page: int) -> None:
        rc = self._refcount.get(page, 0)
        if rc <= 0:
            raise DoubleFreeError(f"paged KV: page {page} released but holds "
                                  "no reference (double free)")
        if rc == 1:
            del self._refcount[page]
            self._free.append(page)
        else:
            self._refcount[page] = rc - 1

    def refcount(self, page: int) -> int:
        """Live references on a page (0 = free)."""
        return self._refcount.get(page, 0)

    def seq_private_pages(self, seq_id: int) -> int:
        """Pages this sequence drew from the free list (its reservation
        consumption) — adopted shared pages are excluded."""
        return self._seq_private.get(seq_id, 0)

    # -- sequence-owned allocation ----------------------------------------
    def alloc_pages(self, seq_id: int, n: int) -> List[int]:
        """Append ``n`` fresh private pages (refcount 1) to a sequence."""
        pages = self._pop_free(n)
        self._seq_pages.setdefault(seq_id, []).extend(pages)
        self._seq_private[seq_id] = self._seq_private.get(seq_id, 0) + n
        return pages

    def alloc_seq(self, seq_id: int, n_tokens: int) -> List[int]:
        return self.alloc_pages(seq_id, -(-n_tokens // self.page_tokens))

    def extend_seq(self, seq_id: int, n_new_tokens: int, cur_len: int) -> List[int]:
        if seq_id not in self._seq_pages:
            raise StaleSequenceError(
                f"paged KV: extend_seq of unknown seq {seq_id}")
        have = len(self._seq_pages[seq_id]) * self.page_tokens
        need_total = cur_len + n_new_tokens
        if need_total <= have:
            return []
        return self.alloc_pages(seq_id, -(-(need_total - have)
                                          // self.page_tokens))

    # -- sharing (the HEROv2 zero-copy move) -------------------------------
    def adopt_pages(self, seq_id: int, pages: Sequence[int]) -> None:
        """Share existing pages into a sequence's list (appended in order,
        so call before allocating the private suffix). Each adoption takes
        one reference; the donor's references are untouched."""
        for p in pages:
            if self._refcount.get(p, 0) <= 0:
                raise StaleSequenceError(
                    f"paged KV: cannot adopt free page {p}")
        for p in pages:
            self._refcount[p] += 1
        self._seq_pages.setdefault(seq_id, []).extend(pages)
        self._seq_private.setdefault(seq_id, 0)

    def retain_pages(self, pages: Sequence[int]) -> None:
        """Take a raw (non-sequence) reference on each page — the prefix
        cache's ownership handle."""
        for p in pages:
            if self._refcount.get(p, 0) <= 0:
                raise StaleSequenceError(
                    f"paged KV: cannot retain free page {p}")
        for p in pages:
            self._refcount[p] += 1

    def release_pages(self, pages: Sequence[int]) -> None:
        """Drop a raw reference on each page (inverse of retain_pages)."""
        for p in pages:
            self._decref(p)

    def fork_page(self, seq_id: int, index: int) -> Tuple[int, int]:
        """Copy-on-write unshare: replace the page at ``index`` of a
        sequence's list with a fresh private page, dropping the sequence's
        reference on the shared original (which survives for its other
        holders). Returns ``(old_page, new_page)`` — the caller copies the
        contents device-side before any divergent write lands."""
        if seq_id not in self._seq_pages:
            raise StaleSequenceError(
                f"paged KV: fork_page of unknown seq {seq_id}")
        pages = self._seq_pages[seq_id]
        if not 0 <= index < len(pages):
            raise StaleSequenceError(
                f"paged KV: fork_page index {index} outside page list "
                f"of seq {seq_id} ({len(pages)} pages)")
        old = pages[index]
        new = self._pop_free(1)[0]
        pages[index] = new
        self._seq_private[seq_id] = self._seq_private.get(seq_id, 0) + 1
        self._decref(old)
        return old, new

    def free_seq(self, seq_id: int) -> None:
        if seq_id not in self._seq_pages:
            raise DoubleFreeError(
                f"paged KV: free_seq of non-resident seq {seq_id} "
                "(double free or stale handle)")
        for p in reversed(self._seq_pages.pop(seq_id)):
            self._decref(p)
        self._seq_private.pop(seq_id, None)

    def audit(self) -> None:
        """Invariant check: every page is free xor refcounted, every listed
        page holds a reference, refcounts cover all holders. Raises
        :class:`VmmError` on violation (tests call this after every op)."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise VmmError("audit: duplicate page on the free list")
        held = set(self._refcount)
        if free & held:
            raise VmmError(f"audit: pages both free and referenced: "
                           f"{sorted(free & held)}")
        if free | held != set(range(self.n_pages)):
            raise VmmError("audit: pages neither free nor referenced: "
                           f"{sorted(set(range(self.n_pages)) - free - held)}")
        if any(rc < 1 for rc in self._refcount.values()):
            raise VmmError("audit: zero/negative refcount retained")
        holders: Dict[int, int] = {}
        for pages in self._seq_pages.values():
            for p in pages:
                holders[p] = holders.get(p, 0) + 1
        for p, n in holders.items():
            if self._refcount.get(p, 0) < n:
                raise VmmError(f"audit: page {p} listed by {n} sequences but "
                               f"refcount is {self._refcount.get(p, 0)}")

    def page_table(self, seq_id: int, max_pages: int) -> np.ndarray:
        """Dense page table row for the device (padded with -1)."""
        if seq_id not in self._seq_pages:
            raise StaleSequenceError(
                f"paged KV: page_table of unknown seq {seq_id}")
        pages = self._seq_pages[seq_id]
        out = np.full((max_pages,), -1, np.int32)
        out[:len(pages)] = pages
        return out

    @property
    def free_pages(self) -> int:
        return len(self._free)
