"""Radix prompt-prefix index: shared-prefix KV reuse across requests.

A copy of ``repro/serve/prefix_cache.py`` (numpy and hashlib only; the
port imports nothing of the JAX package, so it keeps its own copy).

HEROv2's core enabler is a shared virtual address space in which host and
accelerators reference the *same* physical pages instead of copying them.
Applied to serving: hundreds of requests sharing a system-prompt prefix
should reference the same KV pages instead of each prefilling a private
copy. This module is the lookup structure that makes the sharing findable —
a radix tree over token sequences whose nodes hold **page ids** in the
:class:`repro_torch.core.vmm.PagedAllocator` pool:

  * interior/leaf **nodes** are full pages: each node is keyed by its page's
    ``page_tokens`` tokens and holds the physical page id whose KV rows were
    written for exactly those tokens at those positions (prefix sharing is
    position-aligned, so RoPE'd keys are bit-identical for every sharer);
  * **tail records** hang off a node for completed prompts whose last page is
    only partially filled: the partial page id, its token suffix, and the
    prompt's cached greedy **first token** — an exact full-prompt re-arrival
    skips prefill entirely and promotes straight to decode.

Ownership boundaries & invariants:

  * The cache owns *references*, never pages: every cached page id carries
    one ``retain_pages`` reference in the allocator, so eviction anywhere
    else (sequence release, tiered swap-out) can never free a page the cache
    still advertises. Symmetrically, evicting a cache entry only drops the
    cache's reference — a page adopted by a live sequence survives.
  * Pages handed out by :meth:`match` are immutable to their sharers: the
    admitting pool (``PagedCachePool.admit_prefill``) adopts them read-only
    and COW-forks (``cow_unshare``) before the first divergent write — the
    cache itself never observes writes.
  * ``held_pages`` is bounded by ``max_pages``; overflow evicts
    least-recently-matched leaves bottom-up, so an interior page is never
    evicted while a descendant still extends it.
  * The index is host state only (page ids, tokens, a tick). Under tensor
    parallelism every rank builds the same index from the same requests,
    and the page ids it holds name each rank's own kv-head shard of those
    pages (serve/executor.py's rank check holds the tables equal).
  * Insertion only happens for *completed* prefills (the scheduler calls
    :meth:`insert` through serve/cache.PrefixCachingPool when a prompt's
    last chunk lands), so every advertised page holds fully written KV rows
    for its token span.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PrefixMatch:
    """One lookup result: ``pages`` cover token positions ``[0, length)``.

    ``first_token`` is non-None only for an exact full-prompt hit (greedy
    continuation cached at insert time); the engine may then skip prefill
    entirely — the decode step computes position ``length`` directly."""
    length: int
    pages: List[int]
    first_token: Optional[int] = None


_NO_MATCH = PrefixMatch(length=0, pages=[])


# --------------------------------------------------------------------------
# prefix fingerprints — the fleet router's cheap placement signal
# --------------------------------------------------------------------------
# A fingerprint is a rolling digest over a prompt prefix: ``ROOT_DIGEST``
# extended one page-chunk (or tail-token span) at a time. Two prefixes share
# a fingerprint iff they are token-identical, so a replica can export
# ``{digest: covered_tokens}`` for everything its cache holds and the router
# can score "which replica already holds this prompt's longest prefix"
# without shipping token arrays or walking a remote radix tree. Digests are
# content-only (blake2b, fixed root), so placement decisions are
# deterministic across processes and runs — same cache contents, same score.

ROOT_DIGEST = b""
_DIGEST_SIZE = 16


def extend_digest(digest: bytes, tokens) -> bytes:
    """One rolling-digest step: ``digest`` extended by ``tokens`` (an int32
    token span, or its raw little-endian bytes — the radix tree keys chunks
    by exactly those bytes, so both spellings hash identically)."""
    raw = tokens if isinstance(tokens, bytes) else \
        np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes()
    h = hashlib.blake2b(digest, digest_size=_DIGEST_SIZE)
    h.update(raw)
    return h.digest()


def prompt_fingerprints(prompt, page_tokens: int) -> List[Tuple[int, bytes]]:
    """Every candidate-prefix fingerprint of ``prompt``, longest first.

    Candidates are the lengths a cached match can actually end at: each
    full-page boundary (radix-tree nodes) plus, from every boundary, each
    sub-page extension of up to ``page_tokens - 1`` tokens (tail records —
    a cached prompt may end mid-page at any depth). O(len(prompt)) digests;
    the router computes this once per request and checks membership against
    each replica's exported :meth:`PrefixCache.fingerprints`."""
    toks = np.ascontiguousarray(np.asarray(prompt, np.int32))
    L, pt = len(toks), int(page_tokens)
    out: List[Tuple[int, bytes]] = []
    d, k = ROOT_DIGEST, 0
    while True:
        base = k * pt
        for j in range(1, min(pt - 1, L - base) + 1):
            out.append((base + j, extend_digest(d, toks[base:base + j])))
        if base + pt > L:
            break
        d = extend_digest(d, toks[base:base + pt])
        k += 1
        out.append((k * pt, d))
    out.sort(key=lambda t: -t[0])
    return out


def longest_fingerprint_match(candidates: List[Tuple[int, bytes]],
                              fingerprints) -> int:
    """Tokens covered by the longest candidate present in ``fingerprints``
    (a set or dict of digests); 0 when nothing matches."""
    for n, d in candidates:
        if d in fingerprints:
            return n
    return 0


@dataclasses.dataclass
class _Tail:
    """A completed prompt's partial last page (or None when page-aligned)."""
    tokens: np.ndarray          # the < page_tokens trailing tokens
    page: Optional[int]
    first_token: int
    last_used: int = 0


class _Node:
    """One full shared page; children keyed by the next page's token bytes."""
    __slots__ = ("page", "children", "tails", "last_used")

    def __init__(self, page: int):
        self.page = page
        self.children: Dict[bytes, "_Node"] = {}
        self.tails: Dict[bytes, _Tail] = {}
        self.last_used = 0


class PrefixCache:
    """Radix index over cached prompt prefixes, page-granular with partial
    tails. All methods are host-side and O(prompt length); device data never
    moves through this class."""

    def __init__(self, alloc, page_tokens: int, max_pages: int):
        self.alloc = alloc
        self.page_tokens = int(page_tokens)
        self.max_pages = max(1, int(max_pages))
        self._children: Dict[bytes, _Node] = {}   # root level
        self._tails: Dict[bytes, _Tail] = {}      # prompts shorter than a page
        self._held = 0                            # pages the cache references
        self._tick = 0
        # usage counters (hits, shared tokens) live in Engine.stats — a
        # lookup may be retried after a refused admission, so only the
        # admission site knows what was actually reused
        self.insertions = 0
        self.evicted_pages = 0

    @property
    def held_pages(self) -> int:
        return self._held

    def _chunk(self, toks: np.ndarray, i: int) -> bytes:
        pt = self.page_tokens
        return toks[i * pt:(i + 1) * pt].tobytes()

    # -- lookup ------------------------------------------------------------
    def match(self, prompt: np.ndarray) -> PrefixMatch:
        """Longest cached prefix of ``prompt``: walk full-page chunks down
        the radix tree, then try the best partial-tail extension. The match
        is capped at ``len(prompt) - 1`` unless it is an exact full-prompt
        hit with a cached first token — at least one position must be
        prefilled to produce the next-token logits otherwise."""
        toks = np.ascontiguousarray(np.asarray(prompt, np.int32))
        L = len(toks)
        pt = self.page_tokens
        self._tick += 1
        pages: List[int] = []
        children, tails = self._children, self._tails
        k = 0
        while (k + 1) * pt <= L:
            node = children.get(self._chunk(toks, k))
            if node is None:
                break
            node.last_used = self._tick
            pages.append(node.page)
            children, tails = node.children, node.tails
            k += 1
        rem = toks[k * pt:]
        # exact full-prompt hit → cached first token, skip prefill entirely
        if len(rem) < pt:
            tail = tails.get(rem.tobytes())
            if tail is not None:
                tail.last_used = self._tick
                full = pages + ([tail.page] if tail.page is not None else [])
                return PrefixMatch(length=L, pages=full,
                                   first_token=tail.first_token)
        # partial-tail extension: the cached tail sharing the longest common
        # prefix with the remaining tokens (its page is COW-forked by the
        # admitting sequence before the first divergent write)
        best_lcp, best_tail = 0, None
        for tail in tails.values():
            n = min(len(tail.tokens), len(rem))
            lcp = 0
            while lcp < n and tail.tokens[lcp] == rem[lcp]:
                lcp += 1
            if lcp > best_lcp:
                best_lcp, best_tail = lcp, tail
        length = k * pt
        if best_tail is not None and best_lcp > 0:
            best_tail.last_used = self._tick
            take = min(best_lcp, L - 1 - length)   # always leave ≥ 1 token
            if take > 0:
                pages.append(best_tail.page)
                length += take
        elif length >= L:
            # page-aligned prompt fully covered by nodes but no exact tail
            # record: re-prefill the last token (inside the last shared page,
            # which the admitting sequence COW-forks before writing)
            length = L - 1
        if length <= 0:
            return _NO_MATCH
        return PrefixMatch(length=length, pages=pages)

    # -- insertion ---------------------------------------------------------
    def insert(self, pool, seq_id: int, prompt: np.ndarray,
               first_token: int) -> int:
        """Index a just-completed prefill: new full pages become nodes, the
        partial last page becomes a tail record carrying the greedy
        ``first_token``. Every newly cached page gets one cache reference
        (``retain_pages``).

        Sharing a resident sequence's partial tail page makes that
        sequence's *own next decode write* divergent, so the share is taken
        only if ``pool.reserve_extra`` can pre-reserve its COW fork —
        otherwise the tail is skipped and only full pages are cached
        (never-fails-mid-decode outranks reuse). Returns pages cached."""
        toks = np.ascontiguousarray(np.asarray(prompt, np.int32))
        L = len(toks)
        pt = self.page_tokens
        self._tick += 1
        own = pool.alloc._seq_pages[seq_id]
        cached = 0
        children, tails = self._children, self._tails
        node = None
        for i in range(L // pt):
            key = self._chunk(toks, i)
            child = children.get(key)
            if child is None:
                page = own[i]
                self.alloc.retain_pages([page])
                self._held += 1
                cached += 1
                child = _Node(page)
                children[key] = child
            child.last_used = self._tick
            node = child
            children, tails = child.children, child.tails
        rem = toks[(L // pt) * pt:]
        key = rem.tobytes()
        if key not in tails:
            if len(rem) == 0:
                tails[key] = _Tail(tokens=rem, page=None,
                                   first_token=int(first_token),
                                   last_used=self._tick)
            elif pool.reserve_extra(seq_id, 1):
                page = own[L // pt]
                self.alloc.retain_pages([page])
                self._held += 1
                cached += 1
                tails[key] = _Tail(tokens=rem.copy(), page=page,
                                   first_token=int(first_token),
                                   last_used=self._tick)
        if cached:
            self.insertions += 1
        self._evict_over_cap()
        return cached

    # -- eviction ----------------------------------------------------------
    def _evictable(self, require_free: bool = False
                   ) -> List[Tuple[int, object, object]]:
        """(last_used, container, key) for every leaf node and tail record —
        interior nodes become evictable only once their subtree is gone.

        With ``require_free``, only entries whose removal makes progress
        toward an actually-free page qualify: paged entries with refcount 1
        (nothing else holds the page), plus a pageless tail record when it
        is the last thing blocking a freeable leaf node — dropping anything
        else would flush index state without freeing a byte."""
        out = []

        def consider_tail(container, key, tail, node):
            if not require_free:
                out.append((tail.last_used, container, key))
            elif tail.page is not None:
                if self.alloc.refcount(tail.page) == 1:
                    out.append((tail.last_used, container, key))
            elif node is not None and not node.children and \
                    len(node.tails) == 1 and \
                    self.alloc.refcount(node.page) == 1:
                out.append((tail.last_used, container, key))

        for key, tail in self._tails.items():
            consider_tail(self._tails, key, tail, None)
        stack = [(self._children, k, n) for k, n in self._children.items()]
        while stack:
            parent, key, node = stack.pop()
            for tk, tail in node.tails.items():
                consider_tail(node.tails, tk, tail, node)
            if not node.children and not node.tails and \
                    (not require_free
                     or self.alloc.refcount(node.page) == 1):
                out.append((node.last_used, parent, key))
            for ck, cn in node.children.items():
                stack.append((node.children, ck, cn))
        return out

    def _drop(self, container, key) -> int:
        """Remove one entry, releasing its page reference. Returns pages
        released (0 for an empty page-aligned tail record)."""
        entry = container.pop(key)
        if entry.page is None:               # page-aligned tail record
            return 0
        self.alloc.release_pages([entry.page])
        self._held -= 1
        self.evicted_pages += 1
        return 1

    def evict_lru(self, n_pages: int = 1, require_free: bool = False) -> int:
        """Release up to ``n_pages`` cache references, least-recently-used
        leaves first. Returns references actually released.

        With ``require_free`` (the admission-pressure path), only entries
        whose page would *actually free* are considered — a page still
        adopted by a resident sequence frees no HBM when the cache drops its
        reference, so evicting it would flush the index for zero capacity
        (and empty-tail records, which pin no page at all, are kept). Without
        it (the ``max_pages`` cap path), any leaf is fair game: the cap
        bounds pinned references, not free pages."""
        released = 0
        while released < n_pages:
            cands = self._evictable(require_free)
            if not cands:
                break
            cands.sort(key=lambda t: t[0])
            progressed = False
            for _, container, key in cands:
                released += self._drop(container, key)
                progressed = True
                if released >= n_pages:
                    break
            if not progressed:
                break
        return released

    def _evict_over_cap(self) -> None:
        while self._held > self.max_pages:
            if not self.evict_lru(self._held - self.max_pages):
                break

    def clear(self) -> int:
        """Drop every cached reference (shutdown/reset path)."""
        released = 0
        while True:
            got = self.evict_lru(max(self._held, 1))
            released += got
            if not self._evictable():
                break
        self._children.clear()
        self._tails.clear()
        return released

    # -- fleet routing signal ----------------------------------------------
    def fingerprints(self) -> Dict[bytes, int]:
        """``{digest: covered_tokens}`` for every prefix this cache can
        serve: the rolling digest of each radix-tree chain (full pages) plus
        each tail record's per-token prefixes (a router match mid-tail is a
        real partial-tail hit at admission). Read-only — no LRU ticks, no
        allocator traffic — so replicas can export it every routing pass."""
        out: Dict[bytes, int] = {}

        def put(d, n):
            if n > out.get(d, -1):
                out[d] = n

        def visit_tails(tails, d, base):
            for tail in tails.values():
                for j in range(1, len(tail.tokens) + 1):
                    put(extend_digest(d, tail.tokens[:j]), base + j)

        visit_tails(self._tails, ROOT_DIGEST, 0)
        stack = [(self._children, ROOT_DIGEST, 0)]
        while stack:
            children, d, base = stack.pop()
            for key, node in children.items():
                nd = extend_digest(d, key)
                put(nd, base + self.page_tokens)
                visit_tails(node.tails, nd, base + self.page_tokens)
                stack.append((node.children, nd, base + self.page_tokens))
        return out

    # -- introspection (tests + stats) -------------------------------------
    def cached_pages(self) -> List[int]:
        """Every page id the cache currently references."""
        out = []
        for tail in self._tails.values():
            if tail.page is not None:
                out.append(tail.page)
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            out.append(node.page)
            for tail in node.tails.values():
                if tail.page is not None:
                    out.append(tail.page)
            stack.extend(node.children.values())
        return out

    def stats(self) -> Dict[str, int]:
        return {"prefix_insertions": self.insertions,
                "prefix_evicted_pages": self.evicted_pages,
                "prefix_held_pages": self._held}
