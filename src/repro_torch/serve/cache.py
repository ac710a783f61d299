"""CacheManager: the one cache surface the scheduler programs against.

Counterpart of ``repro/serve/cache.py``, paged-only. The port's stack is
the bottom layer alone, :class:`~repro_torch.serve.kvcache.PagedCachePool`;
the swap tier, the prefix layer and int8 pages are later slices, and
:func:`build_cache_manager` refuses them by name. The protocol lists its
members explicitly, so ``isinstance(pool, CacheManager)`` holds by static
lookup (no ``__getattr__`` delegation).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.models import transformer
from repro_torch.serve.kvcache import PagedCachePool


@runtime_checkable
class CacheManager(Protocol):
    """The paged serving-cache surface the chunked scheduler uses. Every
    implementation upholds never-fails-mid-decode: ``ensure`` on a
    sequence holding a decode reservation cannot raise."""

    page_tokens: int
    max_batch: int
    max_seq: int
    seq_ids: np.ndarray
    lengths: np.ndarray
    pages: list

    def pages_for(self, n_tokens: int) -> int: ...
    def admissible_ever(self, prompt_len: int, max_new: int) -> bool: ...
    def can_admit_prefill(self, prompt_len: int, max_new: int) -> bool: ...
    def admit_prefill(self, seq_id: int, prompt_len: int) -> int: ...
    def can_reserve_decode(self, seq_id: int, prompt_len: int,
                           max_new: int) -> bool: ...
    def reserve_decode(self, seq_id: int, prompt_len: int,
                       max_new: int) -> bool: ...
    def has_decode_reservation(self, seq_id: int, prompt_len: int,
                               max_new: int) -> bool: ...
    def ensure(self, slot: int, n_tokens: int) -> None: ...
    def release(self, slot: int) -> None: ...
    def device_page_tables(self) -> np.ndarray: ...
    def page_table_row(self, slot: int) -> np.ndarray: ...
    def footprint_bytes(self) -> int: ...
    def used_bytes(self) -> int: ...
    def publish_metrics(self, bus) -> None: ...
    def bind_tracer(self, tracer) -> None: ...


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Declarative description of one cache stack (always paged here).
    ``n_pages=None`` sizes the pool at n_slots × max_seq tokens of pages.
    ``tiered``, ``prefix`` and ``kv_dtype="int8"`` are fields as in the
    reference, refused by :func:`build_cache_manager` until ported."""
    page_tokens: int = 16
    n_pages: Optional[int] = None
    tiered: bool = False
    prefix: bool = False
    kv_dtype: str = "compute"

    def resolved_pages(self, n_slots: int, max_seq: int) -> int:
        if self.n_pages is not None:
            return self.n_pages
        return max(1, (n_slots * max_seq) // self.page_tokens)


def build_cache_manager(cfg: transformer.ModelConfig, cache: CacheConfig,
                        n_slots: int, max_seq: int,
                        device="cpu") -> CacheManager:
    """The paged pool described by ``cache``, on ``device``."""
    if cache.tiered:
        raise NotImplementedError(
            "repro_torch: the host-DRAM swap tier is not ported yet "
            "(ROADMAP queue 1, item 9: Tiering)")
    if cache.prefix:
        raise NotImplementedError(
            "repro_torch: the prefix layer is not ported yet "
            "(ROADMAP queue 1, item 10: Prefix sharing)")
    if cache.kv_dtype != "compute":
        raise NotImplementedError(
            f"repro_torch: kv_dtype={cache.kv_dtype!r} is not ported yet "
            "(ROADMAP queue 1, item 8: int8 KV through the engine)")
    return PagedCachePool(cfg, max_batch=n_slots, max_seq=max_seq,
                          n_pages=cache.resolved_pages(n_slots, max_seq),
                          page_tokens=cache.page_tokens, device=device)
