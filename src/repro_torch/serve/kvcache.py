"""Paged KV pool: sequences own page lists over a physical page pool.

Counterpart of ``PagedCachePool`` in ``repro/serve/kvcache.py`` at
``kv_dtype="compute"``. The pool holds ``n_pages`` physical pages of
``page_tokens`` rows per layer, ``[count, P, K, pt, hd]`` per group
position, so one *logical* page id maps into every layer's pool at once and
each layer's ``[P, K, pt, hd]`` slice is a contiguous view. A per-sequence
int32 page table translates logical token position to physical page on the
device (kernels/paged_decode_attention.py walks it).

Unlike the reference, page contents are updated **in place**: the paged
steps write into the pool tensors the pool owns, and the executor hands the
same ``pages`` object back, so the scheduler's ``pool.pages = ...`` reads
as it does in the reference.

Ownership boundaries & invariants:

  * This module owns the device page tensors and the host-side slot state
    (seq_ids / lengths). Page identity and refcounts belong to core/vmm.py,
    scheduling to serve/scheduler.py.
  * **Never-fails-mid-decode**: every admitted sequence's reservation
    covers its worst-case page growth, so ``ensure`` on a resident sequence
    cannot raise; pool exhaustion surfaces as an admission refusal.
  * **No-leak accounting**: releasing every slot returns every page to the
    free list and empties the reservation table.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import vmm
from repro_torch.models import transformer
from repro_torch.serve import trace

_PAGEABLE = ("gqa", "global", "shared")


def token_bytes(cfg: transformer.ModelConfig) -> int:
    """Per-token cache footprint (all layers) for capacity planning, at
    the reference's 2-byte estimate per element."""
    total = 0
    for pattern, count in cfg.groups:
        for kind in pattern:
            mixer, _ = transformer.parse_kind(kind)
            if mixer in _PAGEABLE:
                total += count * 2 * cfg.n_kv * cfg.hd * 2
    return total


class PagedCachePool:
    """Paged serving pool at the model's compute dtype.

    Admission is reservation-based: chunked admission reserves and
    allocates the prompt's pages (``admit_prefill``), promotion tops the
    reservation up to the decode worst case (``reserve_decode``), and decode
    grows the page list on demand (``ensure``), which the reservation
    guarantees never fails.
    """

    def __init__(self, cfg: transformer.ModelConfig, max_batch: int,
                 max_seq: int, n_pages: int, page_tokens: int = 16,
                 device="cpu"):
        for pattern, _ in cfg.groups:
            for kind in pattern:
                mixer, _ = transformer.parse_kind(kind)
                if mixer not in _PAGEABLE:
                    raise ValueError(
                        f"PagedCachePool: mixer {mixer!r} is not pageable "
                        f"(supported: {_PAGEABLE})")
        if cfg.logit_softcap:
            raise ValueError("PagedCachePool: the paged attention kernels "
                             "have no logit-softcap path")
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.page_tokens = page_tokens
        self.max_pages_per_seq = -(-max_seq // page_tokens)
        self.alloc = vmm.PagedAllocator(n_pages, page_tokens,
                                        max(1, token_bytes(cfg)))
        self.device = torch.device(device)
        K, hd = cfg.n_kv, cfg.hd
        self.pages = []
        for pattern, count in cfg.groups:
            self.pages.append(tuple(
                {name: torch.zeros((count, n_pages, K, page_tokens, hd),
                                   dtype=cfg.compute_dtype,
                                   device=self.device)
                 for name in ("k", "v")}
                for _ in pattern))
        self.seq_ids = np.full(max_batch, -1, np.int64)
        self.lengths = np.zeros(max_batch, np.int64)   # valid KV rows per slot
        self._reserved: Dict[int, int] = {}            # seq_id -> pages
        self.tracer = trace.null_tracer()

    # -- admission --------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_tokens)

    def _worst_pages(self, prompt_len: int, max_new: int) -> int:
        """Worst-case page need: at least one decoded token's KV lands at
        position prompt_len, so the floor on generated tokens is 1."""
        return self.pages_for(
            min(prompt_len + max(max_new, 1), self.max_seq))

    def _reservation_debt(self) -> int:
        """Reserved-but-not-yet-drawn pages across resident sequences."""
        return sum(max(0, reserved - self.alloc.seq_private_pages(sid))
                   for sid, reserved in self._reserved.items())

    def admissible_ever(self, prompt_len: int, max_new: int) -> bool:
        """False iff the request can never fit, even on an idle pool."""
        worst = self._worst_pages(prompt_len, max_new)
        return (worst <= self.max_pages_per_seq
                and worst <= self.alloc.n_pages
                and prompt_len < self.max_seq)

    def can_admit_prefill(self, prompt_len: int, max_new: int) -> bool:
        """Chunked admission needs only the *prompt* pages now; the decode
        worst case is topped up at promotion (``reserve_decode``)."""
        if not np.any(self.seq_ids < 0):
            return False                               # no slot
        if not self.admissible_ever(prompt_len, max_new):
            return False
        return self.pages_for(prompt_len) <= \
            self.alloc.free_pages - self._reservation_debt()

    def admit_prefill(self, seq_id: int, prompt_len: int) -> int:
        """Reserve and allocate the prompt's pages, so every chunk
        ``[start, start+C)`` lands in pages the sequence owns; claim a
        slot. No decode reservation yet."""
        if seq_id in self.alloc._seq_pages or seq_id in self._reserved:
            raise ValueError(f"paged KV: seq_id {seq_id} already resident "
                             "(page lists would silently merge)")
        need = self.pages_for(prompt_len)
        if need > self.alloc.free_pages - self._reservation_debt() or \
                not np.any(self.seq_ids < 0):
            raise MemoryError("paged KV: prefill admission refused")
        slot = int(np.where(self.seq_ids < 0)[0][0])
        self._reserved[seq_id] = need
        self.alloc.alloc_pages(seq_id, need)
        self.seq_ids[slot] = seq_id
        self.lengths[slot] = 0
        return slot

    def can_reserve_decode(self, seq_id: int, prompt_len: int,
                           max_new: int) -> bool:
        extra = self._worst_pages(prompt_len, max_new) - \
            self._reserved.get(seq_id, 0)
        return extra <= 0 or \
            extra <= self.alloc.free_pages - self._reservation_debt()

    def reserve_decode(self, seq_id: int, prompt_len: int,
                       max_new: int) -> bool:
        """Top the prompt-only reservation up to the decode worst case (the
        promotion gate). False leaves the reservation unchanged."""
        if not self.can_reserve_decode(seq_id, prompt_len, max_new):
            return False
        self._reserved[seq_id] = max(self._reserved.get(seq_id, 0),
                                     self._worst_pages(prompt_len, max_new))
        return True

    def has_decode_reservation(self, seq_id: int, prompt_len: int,
                               max_new: int) -> bool:
        return self._reserved.get(seq_id, 0) >= \
            self._worst_pages(prompt_len, max_new)

    # -- residency ----------------------------------------------------------
    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow slot's page list so positions < n_tokens are mapped (never
        fails for admitted sequences — the reservation covers it)."""
        sid = int(self.seq_ids[slot])
        self.alloc.extend_seq(sid, n_tokens - int(self.lengths[slot]),
                              int(self.lengths[slot]))

    def release(self, slot: int) -> None:
        """Drop a resident sequence and every page reference it holds."""
        sid = int(self.seq_ids[slot])
        if sid < 0:
            raise vmm.StaleSequenceError(
                f"paged KV: release of free slot {slot} (double release?)")
        self.alloc.free_seq(sid)
        self._reserved.pop(sid, None)
        self.seq_ids[slot] = -1
        self.lengths[slot] = 0

    # -- host views of the page tables ---------------------------------------
    def device_page_tables(self) -> np.ndarray:
        """[max_batch, max_pages_per_seq] int32, -1 = unmapped (host array;
        the scheduler moves it to the device)."""
        out = np.full((self.max_batch, self.max_pages_per_seq), -1, np.int32)
        for slot in range(self.max_batch):
            sid = int(self.seq_ids[slot])
            if sid >= 0:
                out[slot] = self.alloc.page_table(sid, self.max_pages_per_seq)
        return out

    def page_table_row(self, slot: int) -> np.ndarray:
        """One slot's page-table row (a prefill chunk is one sequence's)."""
        sid = int(self.seq_ids[slot])
        if sid < 0:
            raise ValueError(f"paged KV: page_table_row of free slot {slot}")
        return self.alloc.page_table(sid, self.max_pages_per_seq)

    # -- accounting -------------------------------------------------------
    def page_nbytes(self) -> int:
        """Real bytes one logical page occupies across every pool leaf."""
        return sum(arr.numel() // arr.shape[1] * arr.element_size()
                   for per_pos in self.pages for kv in per_pos
                   for arr in kv.values())

    def footprint_bytes(self) -> int:
        """Device memory held by the page pool."""
        return self.alloc.n_pages * self.page_nbytes()

    def used_bytes(self) -> int:
        return (self.alloc.n_pages - self.alloc.free_pages) * \
            self.page_nbytes()

    def publish_metrics(self, bus) -> None:
        """Page pressure onto the engine metrics bus (observe-only)."""
        bus.set("free_pages", self.alloc.free_pages)
        bus.set("used_pages", self.alloc.n_pages - self.alloc.free_pages)
        bus.set("reservation_debt_pages", self._reservation_debt())
        bus.set("used_bytes", self.used_bytes())
        bus.set("kv_page_nbytes", self.page_nbytes())
        bus.set("kv_footprint_bytes", self.footprint_bytes())
        bus.set("kv_quantized", 0)

    def bind_tracer(self, tracer) -> None:
        self.tracer = tracer
