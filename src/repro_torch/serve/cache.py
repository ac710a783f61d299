"""CacheManager: the one cache surface the scheduler programs against.

Counterpart of ``repro/serve/cache.py``. A stack is composed bottom-up
from a declarative :class:`CacheConfig`, in the reference's layer order::

    PrefixCachingPool            (this module — radix reuse + COW refs)
      └─ TieredCachePool         (serve/tiering.py — host-DRAM swap tier)
           └─ PagedCachePool     (serve/kvcache.py — vmm pages +
                                  reservations, compute-dtype or int8)

so :func:`build_cache_manager` builds eight stacks: {paged, int8} ×
{±tiered} × {±prefix}. The prefix layer sees the tier-aware pool, so
adopted pages survive a swap-out; the tier sees raw page accounting to
budget its copies.

Unlike the reference, each layer is a subclass of the one below, not a
wrapper delegating through ``__getattr__`` (tiered + prefix is
:class:`TieredPrefixCachingPool`, whose method order puts the prefix layer
over the tier): a ``runtime_checkable`` ``isinstance`` looks members up
statically on Python 3.12, so ``isinstance(pool, CacheManager)`` holds for
every stack here.

Ownership: this module owns stack composition only. Page accounting stays
in kvcache.py, tier movement in tiering.py, prefix lookup in
prefix_cache.py, policy in scheduler.py.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.models import transformer
from repro_torch.serve.kvcache import PagedCachePool
from repro_torch.serve.prefix_cache import PrefixCache, PrefixMatch
from repro_torch.serve.tiering import TieredCachePool


@runtime_checkable
class CacheManager(Protocol):
    """The paged serving-cache surface the scheduler uses (the chunked and
    the monolithic loops). Every implementation upholds
    never-fails-mid-decode: ``ensure`` and ``cow_unshare`` on a sequence
    holding a decode reservation cannot raise."""

    page_tokens: int
    max_batch: int
    max_seq: int
    seq_ids: np.ndarray
    lengths: np.ndarray
    pages: list
    prefix: Optional[PrefixCache]

    def pages_for(self, n_tokens: int) -> int: ...
    def padded_len(self, n_tokens: int) -> int: ...
    def admissible_ever(self, prompt_len: int, max_new: int) -> bool: ...
    def can_admit(self, prompt_len: int, max_new: int) -> bool: ...
    def admit(self, seq_id: int, prompt_len: int, max_new: int) -> int: ...
    def can_admit_prefill(self, prompt_len: int, max_new: int,
                          n_shared_pages: int = 0,
                          match_len: int = 0) -> bool: ...
    def admit_prefill(self, seq_id: int, prompt_len: int,
                      shared_pages: Optional[List[int]] = None,
                      match_len: int = 0) -> int: ...
    def reserve_extra(self, seq_id: int, n: int = 1) -> bool: ...
    def can_reserve_decode(self, seq_id: int, prompt_len: int,
                           max_new: int) -> bool: ...
    def reserve_decode(self, seq_id: int, prompt_len: int,
                       max_new: int) -> bool: ...
    def has_decode_reservation(self, seq_id: int, prompt_len: int,
                               max_new: int) -> bool: ...
    def ensure(self, slot: int, n_tokens: int) -> None: ...
    def cow_unshare(self, slot: int, pos: int) -> bool: ...
    def release(self, slot: int) -> None: ...
    def write_prefill(self, slot: int, caches, length: int) -> None: ...
    def device_page_tables(self) -> np.ndarray: ...
    def page_table_row(self, slot: int) -> np.ndarray: ...
    def footprint_bytes(self) -> int: ...
    def used_bytes(self) -> int: ...
    def publish_metrics(self, bus) -> None: ...
    def bind_tracer(self, tracer) -> None: ...


class PrefixCachingPool(PagedCachePool):
    """Shared-prefix reuse layer: a paged pool with a radix prompt index.

    Adds the :class:`PrefixCache` and its surface: ``match`` before
    admission, ``insert`` at prefill completion, ``evict_cached`` under
    page pressure. The cache holds page *references* (vmm retain), never
    pages, so every no-leak property of the pool survives. Every protocol
    member is the pool's own.
    """

    def __init__(self, cfg: transformer.ModelConfig, *args,
                 max_pages: int, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        self.prefix = PrefixCache(self.alloc, self.page_tokens,
                                  max_pages=max_pages)

    def match(self, prompt: np.ndarray) -> PrefixMatch:
        """Longest cached prefix of ``prompt`` (pages stay cache-owned until
        the admitting sequence adopts them)."""
        return self.prefix.match(prompt)

    def insert(self, seq_id: int, prompt: np.ndarray,
               first_token: int) -> int:
        """Index a completed prefill; returns pages newly cached."""
        return self.prefix.insert(self, seq_id, prompt, first_token)

    def evict_cached(self, n_pages: int = 1,
                     require_free: bool = False) -> int:
        """Release up to ``n_pages`` cache references (LRU leaves first)."""
        return self.prefix.evict_lru(n_pages, require_free=require_free)

    def publish_metrics(self, bus) -> None:
        """The pool's gauges, then the index's: held pages, insertions,
        evictions (the scheduler publishes the hit counters it owns)."""
        super().publish_metrics(bus)
        s = self.prefix.stats()
        bus.set("prefix_held_pages", s["prefix_held_pages"])
        bus.set_total("prefix_insertions", s["prefix_insertions"])
        bus.set_total("prefix_evicted_pages", s["prefix_evicted_pages"])


class TieredPrefixCachingPool(PrefixCachingPool, TieredCachePool):
    """The prefix layer over the swap tier over the pool. Construction and
    ``publish_metrics`` run through both layers by ``super()``: the pool's
    gauges, then the tier's, then the index's."""


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Declarative description of one cache stack.

    ``paged`` selects the page pool at the bottom (``EngineConfig.
    normalized()`` sets it where a layer above or the chunked loop implies
    it; without it the engine serves from the dense slot pool,
    serve/kvcache.py ``CachePool``). ``n_pages=None`` sizes the pool at
    n_slots × max_seq tokens of pages.
    ``tiered`` adds the host-DRAM swap tier, whose cold tier may hold
    ``host_budget_bytes`` (default: eight hot pools of page bytes).
    ``prefix`` adds the radix reuse layer, whose cache may pin at most
    ``prefix_pages`` pages (default: half the pool). ``kv_dtype`` is
    ``"compute"`` (pages at the compute dtype) or ``"int8"`` (pages with
    per-(page, kv head) f32 scales)."""
    paged: bool = False
    page_tokens: int = 16
    n_pages: Optional[int] = None
    tiered: bool = False
    host_budget_bytes: Optional[int] = None
    prefix: bool = False
    prefix_pages: Optional[int] = None
    kv_dtype: str = "compute"

    def resolved_pages(self, n_slots: int, max_seq: int) -> int:
        if self.n_pages is not None:
            return self.n_pages
        return max(1, (n_slots * max_seq) // self.page_tokens)


def build_cache_manager(cfg: transformer.ModelConfig, cache: CacheConfig,
                        n_slots: int, max_seq: int, device="cpu",
                        tp: int = 1, rank: int = 0) -> CacheManager:
    """Compose the stack described by ``cache``, bottom-up, on ``device``;
    under tp the pages hold rank ``rank``'s kv-head shard."""
    n_pages = cache.resolved_pages(n_slots, max_seq)
    kwargs = dict(max_batch=n_slots, max_seq=max_seq, n_pages=n_pages,
                  page_tokens=cache.page_tokens, device=device,
                  kv_dtype=cache.kv_dtype, tp=tp, rank=rank)
    if cache.tiered:
        kwargs["host_budget_bytes"] = cache.host_budget_bytes
    if cache.prefix:
        # the cap bounds how many hot pages the cache may pin; admission
        # evicts LRU entries when it needs them back
        kwargs["max_pages"] = (cache.prefix_pages
                               if cache.prefix_pages is not None
                               else max(1, n_pages // 2))
    cls = {(False, False): PagedCachePool, (True, False): TieredCachePool,
           (False, True): PrefixCachingPool,
           (True, True): TieredPrefixCachingPool}[cache.tiered, cache.prefix]
    return cls(cfg, **kwargs)
